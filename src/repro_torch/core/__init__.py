from repro_torch.core.dataflow import Dataflow  # noqa: F401
from repro_torch.core.ir import PhysicalOp, PhysicalPlan  # noqa: F401
from repro_torch.core.passes import PassPipeline, build_pipeline  # noqa: F401
from repro_torch.core.table import Table, Row  # noqa: F401
