"""Serving runtime of the port: the request server over one executor.

- ``EngineCore``       one tier's batch path (encode / prefill / decode)
- ``CascadePolicy``    exit/offload decisions (progressive confidence)
- ``OffloadPipeline``  Eq. 2 → Eq. 3 → link → GS stage
- ``CascadeExecutor``  Algorithm 1, one request at a time
- ``CascadeServer``    the two-tier request server
"""
from repro_torch.serving.request import (Request, Response, TIERS,  # noqa: F401
                                         scene_key)
from repro_torch.serving.engine_core import (EngineCore,  # noqa: F401
                                             shared_core)
from repro_torch.serving.policy import (CascadePolicy,  # noqa: F401
                                        ProgressiveConfidencePolicy)
from repro_torch.serving.offload import GSView, OffloadPipeline  # noqa: F401
from repro_torch.serving.executor import (CascadeExecutor,  # noqa: F401
                                          ExecutionResult)
from repro_torch.serving.cascade_server import CascadeServer  # noqa: F401
