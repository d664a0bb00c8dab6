"""Roofline terms of a traced step on the H100 (``analysis``)."""
