"""The offline pipeline's networks (counterpart of pipeline/): so far the
FAN landmark network (``pipeline.fan``), which the second stage's
landmark loss also runs."""
