"""sw_fused_roofline: B3's share of its roofline
(readers.sw_fused_roofline)."""

from portbench.readers import sw_fused_roofline as read  # noqa: F401
