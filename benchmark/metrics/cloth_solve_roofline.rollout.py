"""Share of its roofline of every cloth solve in the rollout cells' traced slice: the larger of bytes over 3.35 TB/s and f32 operations over 67 TFLOP/s (counts/cloth_solve.py), over the device time inside the calls."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rollout", "cloth_solve")
