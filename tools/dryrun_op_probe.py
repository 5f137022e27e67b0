"""Per-op counts of one dry-run step, to find where two torch versions lay
a step out differently (``launch/dryrun.py``).

Each case ``arch:shape:engine:layers`` traces the step on the pod1 mesh
(``--multi-pod``: pod2) at that many layers and prints one line
``PROBE {json}``: FLOPs and bytes, the ops the replicate fallback relaxed,
the collectives, and FLOPs and bytes by (op, local shapes).  ``--diff A B``
compares two such outputs (e.g. one made on the card's machine, one here)
op by op.

  PYTHONPATH=src python tools/dryrun_op_probe.py --device cpu \\
      mamba2-130m:train_4k:vmap:2 mamba2-130m:train_4k:scan:2 > here.txt
  python tools/dryrun_op_probe.py --diff here.txt card.txt
"""

from __future__ import annotations

import argparse
import collections
import json


def probe(cases, device: str, multi_pod: bool) -> None:
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    by = collections.defaultdict(lambda: [0, 0, 0])
    dispatch = D.LocalCounter.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        flops, nbytes = self.flops, self.bytes
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented and (self.flops, self.bytes) != (flops, nbytes):
            key = f"{func} {tuple(tuple(t.shape) for t in D._tensors((args, kwargs or {})))}"
            by[key][0] += self.flops - flops
            by[key][1] += self.bytes - nbytes
            by[key][2] += 1
        return out

    D.LocalCounter.__torch_dispatch__ = counted
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    for case in cases:
        arch, shape, engine, layers = case.split(":")
        by.clear()
        D._REPLICATED.clear()
        c = D.trace(D.build_lowered(ARCHS[arch], SHAPES[shape], mesh, fl_mode=engine,
                                    depth={"num_layers": int(layers)}))
        print("PROBE " + json.dumps({
            "case": case, "flops": c.flops, "bytes": c.bytes, "replicated": D._REPLICATED,
            "comms": collections.Counter(str(r) for r in c.comm_records),
            "by": dict(sorted(by.items(), key=lambda kv: -kv[1][0] - kv[1][1] / 1e3))}),
            flush=True)


def diff(path_a: str, path_b: str, top: int) -> None:
    def load(path):
        with open(path) as f:
            return {d["case"]: d for d in (json.loads(x[6:]) for x in f if x.startswith("PROBE "))}

    a, b = load(path_a), load(path_b)
    for case in a.keys() & b.keys():
        x, y = a[case], b[case]
        print(f"== {case}: flops {x['flops']} / {y['flops']}, bytes {x['bytes']} / {y['bytes']}, "
              f"replicated {x['replicated']} / {y['replicated']}")
        rows = [(v[1] - u[1], v[0] - u[0], k, u, v) for k in x["by"].keys() | y["by"].keys()
                for u, v in [(x["by"].get(k, [0, 0, 0]), y["by"].get(k, [0, 0, 0]))] if u != v]
        for dbytes, dflops, key, u, v in sorted(rows, key=lambda r: -abs(r[1]) - abs(r[0]) / 1e3)[:top]:
            print(f"  {dflops:+.3e} flops {dbytes:+.3e} bytes  {u} -> {v}  {key[:160]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", help="arch:shape:engine:layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    if args.diff:
        diff(*args.diff, args.top)
    else:
        probe(args.cases, args.device, args.multi_pod)


if __name__ == "__main__":
    main()
