"""Multi-query serving subsystem (the counterpart of
``spark_rapids_tpu.serve``; docs/serving.md).

A long-lived query server multiplexing N concurrent sessions onto one
device runtime:

- ``server.QueryServer``   — socket front end, one session per tenant,
  all sessions sharing the process device runtime (DeviceStore,
  TorchSemaphore, stage cache, plan-rewrite cache); on the CUDA card
  unless the caller asks for ``device="cpu"``;
- ``scheduler.AdmissionController`` — bounded queue + per-tenant
  in-flight limits + fair-share device-memory throttling in front of
  the semaphore; ``scheduler.BatchFusionCoordinator`` — same-shape
  queries under one admission slot;
- ``result_cache``         — the result and subplan caches, checked
  against the input files' fingerprints;
- ``protocol``             — length-prefixed JSON headers with Arrow
  IPC result payloads over a local socket, the JAX package's wire
  byte for byte;
- ``client.ServeClient``   — the matching client.
"""

from spark_rapids_tpu_torch.serve.client import ServeClient  # noqa: F401
from spark_rapids_tpu_torch.serve.scheduler import (  # noqa: F401
    AdmissionController, QueryRejected)
from spark_rapids_tpu_torch.serve.server import QueryServer  # noqa: F401
