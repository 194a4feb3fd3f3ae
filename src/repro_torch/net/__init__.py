"""repro_torch.net - the multi-node network fabric; PyTorch port of
``repro.net``.

Connects several :class:`~repro_torch.core.spin_nic.SpinNIC` instances
over simulated links with loss, reordering, duplication and latency.

  prng.py    threefry2x32 draws, bit for bit ``jax.random``
  link.py    LinkModel - push/pop over a stack of link states
  node.py    Node = SpinNIC + host-side protocol engines (SLMP sender,
             ping-pong client)
  fabric.py  Fabric = N nodes + N ingress links + MAC routing + tick()
"""
from repro_torch.net.fabric import (Fabric, snapshot_from_numpy,
                                    snapshot_to_numpy)
from repro_torch.net.link import Link, LinkConfig, LinkState
from repro_torch.net.node import Node, PingPongClient, SlmpSenderEngine

__all__ = ["Fabric", "Link", "LinkConfig", "LinkState", "Node",
           "PingPongClient", "SlmpSenderEngine", "snapshot_from_numpy",
           "snapshot_to_numpy"]
