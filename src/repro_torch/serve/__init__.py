"""Serving: continuous-batching LM inference with ``flash_decode`` on the
decode path, and batched CNN scoring (counterpart of ``repro.serve``)."""
from repro_torch.serve.api import (classify, generate, load_checkpoint, make_engine,  # noqa: F401
                                  reduce_clients)
from repro_torch.serve.engine import (ClassifyResult, ImageClassifier,  # noqa: F401
                                      ServeEngine, ServeResult)
from repro_torch.serve.scheduler import (BucketSpec, Request,  # noqa: F401
                                         SlotScheduler, default_bucket_layout)
