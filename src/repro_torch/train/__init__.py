"""The port's train step and training loop (the counterpart of
``repro.train``)."""
