"""The port's data pipeline (the counterpart of ``repro.data``)."""
