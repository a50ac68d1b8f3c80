"""Serving runtime of the port: one executor for Algorithm 1 behind the
request server, the batch evaluator and the baselines, and the
continuous-batching engine over the slot table.

- ``EngineCore``       one tier's batch path (encode / prefill / decode) and
                       slot path (admit_many / step, paged KV, speculative
                       decoding, chunked prefill; submit_many under
                       overload control)
- ``ShardedEngineCore`` data-parallel slot table: one ``EngineCore`` per
                       data shard of a mesh behind a scene-affine router
                       (``make_engine_core`` picks it or ``EngineCore``)
- ``InferenceEngine``  request-level continuous batching over a slot table
- ``AdmissionQueue``   overload control's bounded priority queue
                       (``OverloadConfig``; outcomes ``ADMITTED`` /
                       ``QUEUED`` / ``REJECTED``)
- ``CascadePolicy``    exit/offload decisions (SpaceVerse progressive
                       confidence and every baseline strategy)
- ``OffloadPipeline``  Eq. 2 → Eq. 3 → link → GS stage
- ``CascadeExecutor``  the one Algorithm 1 implementation (counterfactual
                       batches and per-request serving)
- ``CascadeServer``    the two-tier request server
"""
from repro_torch.serving.request import (Request, Response, TIERS,  # noqa: F401
                                         PRIORITY_BULK, PRIORITY_NORMAL,
                                         PRIORITY_URGENT, scene_key)
from repro_torch.serving.admission import (ADMITTED, QUEUED,  # noqa: F401
                                           REJECTED, AdmissionQueue,
                                           OverloadConfig)
from repro_torch.serving.engine_core import (EngineCore,  # noqa: F401
                                             EngineCoreConfig, shared_core)
from repro_torch.serving.sharded import (ShardedEngineCore,  # noqa: F401
                                         make_engine_core)
from repro_torch.serving.engine import (EngineConfig,  # noqa: F401
                                        InferenceEngine)
from repro_torch.serving.policy import (AIRGPolicy,  # noqa: F401
                                        CascadePolicy, GroundOnlyPolicy,
                                        ProgressiveConfidencePolicy,
                                        SatelliteOnlyPolicy, TabiPolicy)
from repro_torch.serving.offload import GSView, OffloadPipeline  # noqa: F401
from repro_torch.serving.executor import (CascadeExecutor,  # noqa: F401
                                          ExecutionResult)
from repro_torch.serving.cascade_server import CascadeServer  # noqa: F401
