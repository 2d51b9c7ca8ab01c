"""The port's distributed-training helpers (the counterpart of
``repro.parallel``): gradient compression."""
