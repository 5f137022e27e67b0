"""Plain PyTorch versions of the port's kernels, under the reference's names
(``repro/kernels/ref.py``): the ground truth the kernels are held against."""

from repro_torch.kernels.masked_aggregate import masked_scale_aggregate_ref  # noqa: F401
