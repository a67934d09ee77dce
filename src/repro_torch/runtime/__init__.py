from repro_torch.runtime.runtime import Runtime  # noqa: F401
from repro_torch.runtime.netmodel import NetModel, nbytes  # noqa: F401
from repro_torch.runtime.kvs import KVS, CacheClient  # noqa: F401
from repro_torch.runtime.autoscaler import (Autoscaler,  # noqa: F401
                                            AutoscalerConfig)
