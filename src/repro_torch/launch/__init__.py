"""Drivers of the port's entry points (``serve``)."""
