"""Parallel/distributed execution — the PyTorch twin of
``mxnet_tpu/parallel/``: the training step and its fit loop
(``TrainStep``, ``make_train_step``) over an optional mesh or layout,
the fit loop's fault injection (``resilience``), the placement layer
(``sharding``: ``make_mesh``, ``SpecLayout``, ``P``, the ``data``,
``fsdp``, ``tp`` and ``model`` axes) and the mesh axes on which the JAX
package writes its collectives by hand (``_comm``): ``sp``
(``ring_attention``), ``expert`` (``moe_ffn``) and ``pipe``
(``pipeline_apply``, ``pipeline_from_symbol``), over ``torch.distributed``
ranks joined by ``dist.init``; and ``ps_async``, the asynchronous
parameter server of the ``dist_async`` kvstore (``AsyncPSServer``, a
host process that applies each push on arrival; ``AsyncPSClient`` and
the key-sharded ``ShardedPSClient``).
"""
from .resilience import DeadWorkerError, FaultInjector, RetryPolicy  # noqa: F401
from .trainer import make_train_step, TrainStep  # noqa: F401
from .sharding import (P, SpecLayout, batch_sharding,  # noqa: F401
                       data_parallel_mesh, make_mesh, param_sharding)
from .ring import ring_attention  # noqa: F401
from .pipeline import pipeline_apply, pipeline_from_symbol  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from . import dist  # noqa: F401
from . import ps_async  # noqa: F401
from .ps_async import (AsyncPSClient, AsyncPSServer,  # noqa: F401
                       ShardedPSClient)

