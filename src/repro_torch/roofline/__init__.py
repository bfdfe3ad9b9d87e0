"""Roofline terms of a step on the H100 (the port's ``repro/roofline``)."""
