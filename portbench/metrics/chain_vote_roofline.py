"""chain_vote_roofline: kernel R2's share of its roofline
(chain_vote.roofline_share)."""

from portbench.chain_vote import roofline_share as read  # noqa: F401
