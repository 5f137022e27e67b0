"""Checkpoints of the port: the reference's versioned, atomic layout
(:mod:`~repro_torch.checkpoint.ckpt`) and its full-fidelity round
checkpoints (:mod:`~repro_torch.checkpoint.resume`)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    available_steps,
    latest_step,
    read_meta,
    restore,
    restore_subtree,
    save,
)
from repro_torch.checkpoint.resume import (  # noqa: F401
    CheckpointConfig,
    RoundCheckpoint,
    load_round,
    run_config_doc,
    save_round,
)
