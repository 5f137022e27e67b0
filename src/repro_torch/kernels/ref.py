"""Plain PyTorch versions of the port's kernels, under the reference's names
(``repro/kernels/ref.py``): the ground truth the kernels are held against."""

from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: F401
from repro_torch.kernels.masked_aggregate import masked_scale_aggregate_ref  # noqa: F401
from repro_torch.kernels.norm_aggregate import (  # noqa: F401
    client_sqnorms_ref,
    compress_norm_scale_aggregate_ref,
    norm_scale_aggregate_ref,
)
from repro_torch.kernels.sharded_aggregate import (  # noqa: F401
    sharded_compress_aggregate_ref,
    sharded_masked_aggregate_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: F401
