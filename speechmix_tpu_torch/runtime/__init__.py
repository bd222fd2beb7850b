"""The port's native host runtime (``native.cpp`` bound by ``native.py``)."""
