"""Roofline terms of a dry-run step — the port of ``repro/launch/roofline.py``.

Three terms per (arch, shape, mesh), on the H100 constants of
``launch/mesh.py`` (spec-sheet figures for NVIDIA H100 80GB HBM3, 700.00 W):

  compute    = FLOPs_per_chip / PEAK_FLOPS_BF16           (989 TF bf16)
  memory     = bytes_per_chip / HBM_BW                    (3.35 TB/s)
  collective = ring traffic per chip / link bandwidth      (NVLink 450 GB/s
               within a node, InfiniBand 50 GB/s across nodes)

The dry-run counts rank 0's local work, so FLOPs and bytes are per chip
already.  The collectives are the ones ``CommDebugMode`` saw DTensor issue
(:func:`count_collectives` takes its records in place of the reference's
partitioned HLO text); each op's traffic follows the reference's ring model
(all-reduce 2(g-1)/g, all-gather and all-to-all (g-1)/g of the full tensor,
reduce-scatter (g-1) of the scattered result, collective-permute 1x), and is
charged to NVLink when its group lies within one node, else to InfiniBand.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from repro_torch.launch.mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16


def ring_traffic(op: str, nbytes: float, g: int) -> float:
    """Per-chip traffic of one collective whose result is ``nbytes`` bytes
    over a group of ``g`` ranks (the reference's model)."""
    if op == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if op == "all-gather":
        return nbytes * (g - 1) / g
    if op == "reduce-scatter":
        return nbytes * (g - 1)      # result is the scattered shard
    if op == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes                    # collective-permute


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    raw_bytes: dict = field(default_factory=dict)       # summed result bytes
    traffic_bytes: dict = field(default_factory=dict)   # ring-model per chip
    link_traffic: dict = field(default_factory=dict)    # per chip, 'nvlink' / 'ib'

    def total_raw(self):
        return sum(self.raw_bytes.values())

    def total_traffic(self):
        return sum(self.traffic_bytes.values())


def count_collectives(comm_records) -> CollectiveStats:
    """``comm_records``: one ``(op, nbytes, group_size, intra_node)`` per
    collective, ``op`` in the reference's HLO names, ``nbytes`` the bytes of
    the op's result on this rank."""
    st = CollectiveStats()
    for op, nbytes, g, intra in comm_records:
        traffic = ring_traffic(op, nbytes, g)
        link = "nvlink" if intra else "ib"
        st.counts[op] = st.counts.get(op, 0) + 1
        st.raw_bytes[op] = st.raw_bytes.get(op, 0) + nbytes
        st.traffic_bytes[op] = st.traffic_bytes.get(op, 0) + traffic
        st.link_traffic[link] = st.link_traffic.get(link, 0) + traffic
    return st


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_raw: float
    collective_traffic_per_chip: float
    collective_counts: dict
    compute_s: float
    compute_model_s: float   # analytic floor: MODEL_FLOPS/(chips*peak)
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # 6 * N_active * D (global)
    useful_flops_ratio: float    # model_flops / (flops_per_chip * chips)
    peak_memory_bytes: float | None = None
    notes: str = ""

    def to_json(self):
        return json.dumps(asdict(self), indent=1)


def build_roofline(
    arch, shape, mesh_name, chips, cost, coll: CollectiveStats,
    model_flops: float, peak_memory=None, notes="",
) -> Roofline:
    flops = float(cost.get("flops", 0.0) or 0.0)
    nbytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    compute_s = flops / PEAK_FLOPS_BF16
    compute_model_s = model_flops / (chips * PEAK_FLOPS_BF16)
    memory_s = nbytes / HBM_BW
    coll_s = (coll.link_traffic.get("nvlink", 0.0) / NVLINK_BW
              + coll.link_traffic.get("ib", 0.0) / IB_BW)
    terms = {
        "compute": max(compute_s, compute_model_s),
        "memory": memory_s,
        "collective": coll_s,
    }
    bottleneck = max(terms, key=terms.get)
    total = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, hbm_bytes_per_chip=nbytes,
        collective_bytes_raw=coll.total_raw(),
        collective_traffic_per_chip=coll.total_traffic(),
        collective_counts=coll.counts,
        compute_s=compute_s, compute_model_s=compute_model_s,
        memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total) if total else 0.0,
        peak_memory_bytes=peak_memory,
        notes=notes,
    )
