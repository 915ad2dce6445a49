"""The subscription fan-out plane: the registry and its bitset compiler,
the match on the device, and the WebSocket/SSE broadcast tier behind the
delivery plane. The port of ``binquant_tpu/fanout``."""

from binquant_tpu_torch.fanout.hub import BroadcastOutbox, FanoutHub, ShardedBroadcastOutbox
from binquant_tpu_torch.fanout.kernel import (
    DevicePlanes,
    pack_words_np,
    popcount_words,
    unpack_slots,
    unpack_words_np,
)
from binquant_tpu_torch.fanout.plane import FanoutPlane, FanoutSink
from binquant_tpu_torch.fanout.registry import (
    Subscription,
    SubscriptionRegistry,
)

__all__ = [
    "BroadcastOutbox",
    "ShardedBroadcastOutbox",
    "DevicePlanes",
    "FanoutHub",
    "FanoutPlane",
    "FanoutSink",
    "Subscription",
    "SubscriptionRegistry",
    "pack_words_np",
    "popcount_words",
    "unpack_slots",
    "unpack_words_np",
]
