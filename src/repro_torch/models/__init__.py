"""The port's LLM models (the counterpart of ``repro.models``): the six
families' parameter trees, forward passes and cached decode, in PyTorch."""
