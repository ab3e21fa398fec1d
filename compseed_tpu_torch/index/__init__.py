from compseed_tpu_torch.index.fmindex import FMIndex  # noqa: F401
from compseed_tpu_torch.index.build import build_index  # noqa: F401
