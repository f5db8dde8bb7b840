"""Training: the 3D GAN and the inversion stages (e4e, one-shot): losses,
optimizers, steps and drivers."""
