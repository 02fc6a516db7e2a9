"""device_ms.chain_vote: device ms a batch of kernel R2, the chained vote
(chain_vote.device_ms)."""

from portbench.chain_vote import device_ms as read  # noqa: F401
