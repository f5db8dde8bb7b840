"""The benchmark's plain reference: a frozen copy of the port's plain paths
(`invertavatar_torch`) with the kernels taken out, which decides `correct`.

It imports nothing of the program, of the JAX package or of JAX; the
benchmark hands it the inputs and weights it made itself, and it recomputes
everything the program derives from them. `precision.lower("tf32")` turns it
into the control: the same computation one precision step below."""
