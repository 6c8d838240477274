"""The paper's experiment end to end: LeNet-5 on (synthetic) MNIST with
the full method comparison -- SpC vs SpC(Retrain) vs Pru vs Pru(Retrain)
vs MM -- one run reproducing the structure of the paper's Table 1 + Table
2 row. The counterpart of the JAX package's
``examples/paper_cnn_pipeline.py``, at its constants.

    PYTHONPATH=src python -m repro_torch.launch.paper_cnn [--device cuda|cpu]

It runs on ``cuda`` unless ``--device cpu`` is given; every prox-Adam step
there launches ``csrc/prox_adam.cu`` once per leaf. TF32 is off for the
convolutions and the fc products (``models.cnn.exact_f32``). It prints a
table of accuracy and compression per method. ``main``'s keyword
arguments (the example's constants) let a caller cut the run.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import masks, metrics, mm, pruning
from repro_torch.core.optimizers import prox_adam
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import image_batch
from repro_torch.models.cnn import CNN_ZOO, exact_f32
from repro_torch.train.cnn import (data_for, evaluate_cnn, loss_and_grads,
                                   spc_with_retrain, train_cnn)

STEPS = 250
RETRAIN_STEPS = 100
LAM = 1.0
MM_CONFIG = mm.MMConfig(alpha=1e-2, mu0=0.3, mu_growth=1.2, mu_every=30,
                        c_step_every=30, learning_rate=2e-3)


def main(argv: Optional[list] = None, *, steps: int = STEPS,
         retrain_steps: int = RETRAIN_STEPS, lam: float = LAM,
         mm_config: mm.MMConfig = MM_CONFIG) -> list:
    """Runs the example's six rows, prints its table and returns the rows
    [(method, accuracy, compression)]."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    exact_f32()
    model = CNN_ZOO["lenet5"]
    data_cfg = data_for(model)
    rows = []

    # reference
    ref, _ = train_cnn(model, prox_adam(1e-3, lam=0.0), steps, device=dev)
    rows.append(("reference", evaluate_cnn(model, ref, data_cfg), 0.0))

    # SpC / SpC(Retrain)
    out = spc_with_retrain(model, lam=lam, steps=steps,
                           retrain_steps=retrain_steps, device=dev)
    rows.append(("SpC", evaluate_cnn(model, out["spc_params"], data_cfg),
                 out["spc_compression"]))
    rows.append(("SpC(Retrain)",
                 evaluate_cnn(model, out["retrain_params"], data_cfg),
                 out["retrain_compression"]))

    # Pru / Pru(Retrain) at matched compression
    pruned = pruning.magnitude_prune_global(ref, out["spc_compression"])
    rows.append(("Pru", evaluate_cnn(model, pruned, data_cfg),
                 metrics.compression_rate(pruned)))
    pr_rt, _ = train_cnn(model, prox_adam(1e-3, lam=0.0), retrain_steps,
                         params=pruned, mask=masks.zero_mask(pruned))
    rows.append(("Pru(Retrain)", evaluate_cnn(model, pr_rt, data_cfg),
                 metrics.compression_rate(pr_rt)))

    # MM (from the pretrained reference, as in the paper); mm_update works
    # in place, so it trains a copy
    p = tree_map(lambda t: t.detach().clone(), ref)
    state = mm.mm_init(p, mm_config)
    for s in range(steps):
        _, g = loss_and_grads(model, p, image_batch(data_cfg, s, device=dev))
        with torch.no_grad():
            p, state = mm.mm_update(g, state, p, mm_config)
    final = mm.mm_final_params(p, state)
    rows.append(("MM", evaluate_cnn(model, final, data_cfg),
                 metrics.compression_rate(final)))

    print(f"{'method':14s} {'accuracy':>9s} {'compression':>12s}")
    for name, acc, comp in rows:
        print(f"{name:14s} {acc:9.4f} {100 * comp:11.1f}%")
    return rows


if __name__ == "__main__":
    main()
