"""Gateways and receivers: detection-gated, multi-SF and always-on."""

from .multi_sf import MultiSFReceiver, SfPacket
from .pyramid_gateway import GatewayPacket, PyramidGateway
from .triggered import TriggeredPacket, TriggeredReceiver

__all__ = [
    "MultiSFReceiver", "SfPacket", "GatewayPacket", "PyramidGateway",
    "TriggeredPacket", "TriggeredReceiver",
]
