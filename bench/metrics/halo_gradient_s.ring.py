"""`halo_gradient_s.ring`: seconds of ``run_front``'s ``halo`` and
``gradient`` steps per call (the boundary planes' exchange, then the
fused kernel's halo entry on every held block), on rank 0."""

from bench.layers import step_mean


def read(ctx):
    return step_mean(ctx, "halo", "gradient")
