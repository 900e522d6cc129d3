"""Per-launch bounds of the port's hand-written kernels, and the peaks they
are taken against."""
