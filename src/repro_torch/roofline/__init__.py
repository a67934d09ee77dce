"""Roofline accounting for the port on one NVIDIA H100 (port of the
reference package's ``roofline/``): the card's constants (``hw``), the
analytic executed FLOPs and bytes of a step (``flops``) and the
three-term roofline with a counted source (``analysis``)."""
