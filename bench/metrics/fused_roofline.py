"""`fused_roofline`: the fused lower-star kernel's share of its roofline
(the device function ``fused_lower_star`` that the ``ls_fused_*`` entries
launch):
the least time of its launches (the benchmark's own byte and operation
count at the published H100 peaks, ``bench/roofline.py``) over their
device time in the profiler.  Every launch of the main path covers a
whole grid; the bytes bind."""

from bench import roofline


def read(ctx):
    dt = ctx.get("trace")
    if ctx.get("kind") != "pipeline" or not dt:
        return None
    names = [k for k in dt["kernel_s"] if "fused_lower_star" in k]
    secs = sum(dt["kernel_s"][k] for k in names)
    launches = sum(dt["kernel_n"][k] for k in names)
    if not launches or secs <= 0:
        return None
    least, _ = roofline.fused_launch_bound_s(ctx["nv"])
    return 100.0 * least * launches / secs
