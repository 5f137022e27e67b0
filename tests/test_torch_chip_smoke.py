"""``chip_smoke.py``'s reading of a CUDA graph's DOT dump, on the CPU.

The scan mode's launch check counts each kernel's nodes in the captured
round graph (``graph_kernel_nodes``); the text below has the layout of
``cudaGraphDebugDotPrint``'s verbose dump (mangled names, escaped ``<`` and
``>``, edges after the nodes).  The same patterns name the kernels in a
profiler trace, demangled.
"""

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernel(i, name, grid="1,128,0"):
    return (f'"graph_3_node_{i}"[style="bold" shape="record" label="{{KERNEL\n'
            f'| {{ID | {i} (topoId: {99 - i}) | {name}\\<\\<\\<{grid}\\>\\>\\>}}\n'
            f'| {{{{node handle | func handle}} | {{0x01 | 0x02}}}}\n'
            f'| {{cooperative | 0}}\n}}"];\n\n')


def _memcpy(i):
    return (f'"graph_3_node_{i}"[style="solid" shape="record" label="{{\nMEMCPY\n'
            f'| {{{{ID | node handle}} | {{{i} (topoId: {99 - i}) | 0x03}}}}\n'
            f'| {{kind | DtoD (DEVICE to DEVICE)}}\n}}"];\n\n')


NORM = "_ZN52_GLOBAL__N__1a2b3c4d_17_norm_aggregate_cu_5e6f7a8b12fused_kernelIfLi{}ELi2EEEvPKT_"
MASKED = ("_ZN52_GLOBAL__N__66e176a0_19_masked_aggregate_cu_f633f89929"
          "masked_scale_aggregate_kernelIfEEvPKT_PKfPfii")
OTHER = "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEEEEviT0_T1_"
DOT = ("digraph dot {\nsubgraph cluster_3 {\nlabel=\"graph_3\" graph[style=\"dashed\"];\n"
       + _kernel(0, OTHER) + _kernel(1, NORM.format(0), "115,128,128") + _memcpy(2)
       + _kernel(3, NORM.format(1)) + _kernel(4, NORM.format(1)) + _kernel(5, MASKED)
       + "".join(f'"graph_3_node_{i}" -> "graph_3_node_{i + 1}" [style="solid"];\n'
                 for i in range(5))
       + "}\n}\n")


def test_graph_kernel_nodes_counts_each_kernel_node_once(chip_smoke):
    got = chip_smoke.graph_kernel_nodes(DOT)
    assert got["nodes"] == {"norm_scale_aggregate": 1, "compress_norm_scale_aggregate": 2,
                            "masked_scale_aggregate": 1}
    # the edges' targets are not nodes; the memcpy is a node, not a kernel
    assert (got["kernel_nodes"], got["nodes_total"]) == (5, 6)
    assert "fused_kernel" in got["sample"] or "masked" in got["sample"]


@pytest.mark.parametrize("name, kernel", [
    ("void (anonymous namespace)::fused_kernel<float, 0, 2>(float const*, float const*)",
     "norm_scale_aggregate"),
    ("void (anonymous namespace)::fused_kernel<float, 1, 1>(float const*, float const*)",
     "compress_norm_scale_aggregate"),
    ("void (anonymous namespace)::masked_scale_aggregate_kernel<float>(float const*)",
     "masked_scale_aggregate"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >",
     None),
])
def test_trace_patterns_name_the_profilers_kernels(chip_smoke, name, kernel):
    hits = [k for k, pat in chip_smoke.TRACE_KERNELS.items() if re.search(pat, name)]
    assert hits == ([kernel] if kernel else [])
