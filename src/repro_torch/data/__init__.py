"""The synthetic LM corpus (``pipeline``), the port's copy of ``repro.data``."""
