"""Roofline terms of a step on the H100 (``roofline.analysis``)."""
