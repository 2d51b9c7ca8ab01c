"""The port's optimizer (the counterpart of ``repro.optim``)."""
