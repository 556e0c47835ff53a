"""Gateways and receivers: the FSM gateway over a shard grid, the
detection-gated, multi-SF and always-on ones, and the PDU sink their
packets go to."""

from .gateway import (
    GatewayPlan,
    gateway_receive,
    left_halo_len,
    make_gateway,
    make_mesh,
    right_halo_len,
)
from .multi_sf import MultiSFReceiver, SfPacket
from .pdu_sink import PduEvent, PduSink
from .pyramid_gateway import GatewayPacket, PyramidGateway
from .triggered import TriggeredPacket, TriggeredReceiver

__all__ = [
    "GatewayPlan", "gateway_receive", "left_halo_len", "make_gateway",
    "make_mesh", "right_halo_len", "MultiSFReceiver", "SfPacket",
    "PduEvent", "PduSink", "GatewayPacket", "PyramidGateway",
    "TriggeredPacket", "TriggeredReceiver",
]
