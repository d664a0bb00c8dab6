"""Streaming membership subsystem.  So far only the admission controller
(``admission.py``), which the adaptive tier uses; the generational filter
and its ``probe_multi`` kernel come with the streaming slice."""
