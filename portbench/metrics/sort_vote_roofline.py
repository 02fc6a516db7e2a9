"""sort_vote_roofline: B2's monolithic entry's share of its roofline
(readers.sort_vote_roofline)."""

from portbench.readers import sort_vote_roofline as read  # noqa: F401
