"""Share of its roofline of every segment_sum call in the rollout cells' traced slice: bytes (counts/segment_sum.py) over 3.35 TB/s, over the device time inside the calls."""

from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "rollout", "segment_sum")
