"""Gateways and receivers: detection-gated, multi-SF and always-on, and
the PDU sink their packets go to."""

from .multi_sf import MultiSFReceiver, SfPacket
from .pdu_sink import PduEvent, PduSink
from .pyramid_gateway import GatewayPacket, PyramidGateway
from .triggered import TriggeredPacket, TriggeredReceiver

__all__ = [
    "MultiSFReceiver", "SfPacket", "PduEvent", "PduSink", "GatewayPacket",
    "PyramidGateway", "TriggeredPacket", "TriggeredReceiver",
]
