"""Roofline terms of a step on the H100 from an op-level count of its
cost (``repro/roofline``)."""
