"""Entry points of the port: greedy batched generation (``serve``)."""
