"""repro_torch.mpi — MPI point-to-point and collectives over the fabric,
with receive-side datatype processing offloaded to the SpinNIC (paper
§V-C as a real multi-node experiment).  PyTorch port of ``repro.mpi``:
the host logic is the JAX package's numpy, copied, over the port's
``core`` and ``net``; ``Communicator(..., device=)`` places the NICs.

  wire.py          envelopes, msg_id packing, reliable control datagrams
  datatypes.py     committed-datatype registry (job-wide commit cache)
  engine.py        per-rank host engine: tag matching, eager/rendezvous,
                   closure-free checkpointable protocol state
  communicator.py  ranks ↔ fabric nodes, requests, progress, checkpoint
  collectives.py   nonblocking plan-based collectives: binomial trees,
                   recursive-doubling allreduce, Bruck alltoall(v)

Quick taste::

    from repro_torch import mpi
    from repro_torch.core import ddt

    reg = mpi.DatatypeRegistry()
    col = reg.register(ddt.Vector(64, 1, 8, ddt.MPI_FLOAT), count=1)
    comm = mpi.Communicator(4, registry=reg)
    r = comm.irecv(1, buf, source=mpi.ANY_SOURCE, tag=7)
    s = comm.isend(0, 1, data, tag=7, datatype=col)   # NIC unpacks
    h = mpi.iallreduce(comm, vals)                    # log-step plan
    while not h.test():
        compute_something(); comm.progress()          # real overlap
    comm.waitall([r, s, h])
"""
from repro_torch.mpi.collectives import (
    ALLREDUCE_RAB_MIN_BYTES, ALLREDUCE_RD_MAX_BYTES, ALLTOALL_BRUCK_MAX_BLOCK,
    BCAST_PIPELINE_MIN_BYTES, CollRequest, allreduce, alltoall, alltoallv,
    barrier, bcast, iallreduce, ialltoall, ialltoallv, ibarrier, ibcast,
    ireduce, reduce)
from repro_torch.mpi.communicator import (
    COLL_TAG_BASE, BufferPool, Communicator, MpiConfig, PersistentRequest,
    clear_nic_cache)
from repro_torch.mpi.datatypes import (COMMIT_COUNTERS, DatatypeRegistry,
                                       clear_commit_cache)
from repro_torch.mpi.engine import (ANY_SOURCE, ANY_TAG, MpiHostEngine,
                                    Request)
from repro_torch.mpi.wire import CTRL_PORT, DATA_PORT, EAGER_PORT

__all__ = ["Communicator", "MpiConfig", "DatatypeRegistry", "MpiHostEngine",
           "Request", "CollRequest", "BufferPool", "PersistentRequest",
           "ANY_SOURCE", "ANY_TAG",
           "bcast", "reduce", "allreduce", "alltoall", "alltoallv",
           "barrier", "ibcast", "ireduce", "iallreduce", "ialltoall",
           "ialltoallv", "ibarrier", "COLL_TAG_BASE",
           "ALLREDUCE_RD_MAX_BYTES", "ALLREDUCE_RAB_MIN_BYTES",
           "BCAST_PIPELINE_MIN_BYTES", "ALLTOALL_BRUCK_MAX_BLOCK",
           "COMMIT_COUNTERS", "clear_commit_cache", "clear_nic_cache",
           "EAGER_PORT", "DATA_PORT", "CTRL_PORT"]
