"""The port's binding of the native runtime library (`native/` at the root
of the repository): `runtime.py`."""
