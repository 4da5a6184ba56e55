#!/usr/bin/env python3
"""ms an epoch of the epoch engine at full size, on the card, for two trees in turns.

    python3 tools/torch_engine_bench.py [--seed 0] [--src OTHER/src] [--only LABEL ...]
                                        [--report PATH]

Makes ``chip_smoke.py``'s data on the card from --seed (least squares and
multinomial logistic regression at the ImageNet shapes, matrix completion
at the Netflix shapes, the Table-1 cell's problem) and times the const
schedules of its phase 27 through ``frank_wolfe.fit`` from built states:
MTLS const:2 and ``block:32:adapt`` const:8, logistic const:1, MC dense and
int8 const:3, MC ``block:8:adapt`` const:4, and the Table-1 problem's rank1
const:2 and ``block:32:adapt`` const:8 (MTLS and MC), in blocks of 4 or 5
epochs. A callback times each segment; the figure is ms an epoch over the
segments after the first. A tree whose engine has modes is timed in
``scan`` and in ``legacy``; an older tree (``--src`` of its ``git
archive``), whose engine has none, as it runs. Run two trees in turns in
one call (old, new, new, old) to compare them. Prints the card's name and
power limit first, and one line a configuration.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is run (default: this checkout's)")
    ap.add_argument("--only", action="append", help="time only these labels")
    ap.add_argument("--report", default=None, help="also write the figures here (JSON)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke as cs
    from repro_torch import comm, resolve_device
    from repro_torch.core import engine, frank_wolfe, tasks
    from repro_torch.kernels import _build
    from repro_torch.launch import dfw

    if not torch.cuda.is_available():
        print("needs CUDA: the times come from the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(f"repro_torch from {Path(engine.__file__).resolve().parents[1]}")
    modes = ("scan", "legacy") if hasattr(engine, "MODES") else (None,)
    dev = resolve_device("cuda")
    _build.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 27)
    out = {"card": smi, "src": str(Path(args.src).resolve())}
    ls = dict(step_size="linesearch")

    def timed(label, ktask, fresh, mu, kw):
        if args.only and label not in args.only:
            return
        row = out[label] = {}
        for mode in modes:
            seg_log = []
            torch.cuda.synchronize()
            res = frank_wolfe.fit(ktask, fresh(), mu=mu, key=args.seed, device=dev,
                                  callback=cs.segment_timer(torch, seg_log), **kw,
                                  **({} if mode is None else {"mode": mode}))
            row[mode or "tree"] = cs.steady_epoch_ms(seg_log)
            del res
            torch.cuda.empty_cache()
        print(f"{label} ({kw['schedule']}, blocks of {kw.get('block_epochs')}): ms an epoch "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()))

    X, Y = cs.dense_data(torch, gen, dev, cs.PAPER_N)
    mtls = dfw.kernelize(tasks.MultiTaskLeastSquares(cs.PAPER_D, cs.PAPER_M))
    base = mtls.init_state(X, Y)
    timed("mtls", mtls, lambda: base._replace(r=-Y), 1.0,
          dict(ls, num_epochs=12, schedule="const:2", block_epochs=4))
    timed("mtls block:32:adapt", mtls, lambda: base._replace(r=-Y), 1.0,
          dict(ls, num_epochs=10, schedule="const:8", solver="block:32:adapt", block_epochs=5))
    del base, Y
    torch.cuda.empty_cache()
    labels = cs.planted_labels(torch, gen, dev, X)
    logi = dfw.kernelize(tasks.MultinomialLogistic(cs.PAPER_D, cs.PAPER_M))
    base = logi.init_state(X, labels)
    timed("logistic", logi, lambda: base._replace(z=torch.zeros_like(base.z)), 10.0,
          dict(num_epochs=12, schedule="const:1", block_epochs=4))
    del base, labels, X
    torch.cuda.empty_cache()

    idx, yw, _, mu = cs.make_mc_data(torch, gen, dev, cs.NF_P, cs.NF_TEST)
    mc = dfw.kernelize(tasks.MatrixCompletion(cs.NF_D, cs.NF_M))
    base = mc.init_state(idx, yw)
    del idx, yw
    torch.cuda.empty_cache()

    def mc_fresh():
        return base._replace(resid=base.resid.clone(), resid_by_row=base.resid_by_row.clone(),
                             resid_by_col=base.resid_by_col.clone())

    steady = dict(ls, num_epochs=16, schedule="const:3", block_epochs=4)
    timed("mc dense", mc, mc_fresh, mu, steady)
    timed("mc int8", mc, mc_fresh, mu, dict(steady, num_epochs=12, reducer=comm.Int8Reducer()))
    timed("mc block:8:adapt", mc, mc_fresh, mu,
          dict(ls, num_epochs=10, schedule="const:4", solver="block:8:adapt", block_epochs=5))
    del base
    torch.cuda.empty_cache()

    g1 = torch.Generator(device=dev)
    for kind in ("mtls", "mc"):
        g1.manual_seed(cs._table1_seed(args.seed, 0))
        x, y = cs.table1_data(torch, g1, dev, kind)
        task = dfw.kernelize((tasks.MultiTaskLeastSquares if kind == "mtls"
                              else tasks.MatrixCompletion)(cs.TABLE1["d"], cs.TABLE1["m"]))
        t_base = task.init_state(x, y)
        if kind == "mtls":
            def fresh():
                return t_base._replace(r=-y)
        else:
            def fresh():
                return t_base._replace(resid=t_base.resid.clone(),
                                       resid_by_row=t_base.resid_by_row.clone(),
                                       resid_by_col=t_base.resid_by_col.clone())
        timed(f"table-1 {kind} rank1", task, fresh, 1.0,
              dict(ls, num_epochs=40, schedule="const:2", block_epochs=5))
        timed(f"table-1 {kind} block:32:adapt", task, fresh, 1.0,
              dict(ls, num_epochs=20, schedule="const:8", solver="block:32:adapt",
                   block_epochs=5))
        del x, y, t_base
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
