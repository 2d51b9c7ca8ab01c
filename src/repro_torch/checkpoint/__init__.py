"""The port's checkpoint manager (the counterpart of ``repro.checkpoint``)."""
