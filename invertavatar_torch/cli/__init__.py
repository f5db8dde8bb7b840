"""Command-line entry points: GAN reenactment and few-shot inversion with
reenactment."""
