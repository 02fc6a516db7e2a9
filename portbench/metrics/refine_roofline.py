"""refine_roofline: R1's share of its roofline (readers.refine_roofline)."""

from portbench.readers import refine_roofline as read  # noqa: F401
