#!/usr/bin/env python3
"""Time the fused Prox-ADAM update (``csrc/prox_adam.cu``) of a checkout,
to hold a change of it against its parent on one card.

    python3 tools/prox_adam_rows.py ROOT [--variants=v2,v4,t256] >> rows.log

Builds the prox_adam kernel of the checkout at ROOT (on first use) and
prints one JSON line: three timings each (``chip_smoke.time_ms``, f32
leaves cold in L2, the soft threshold where noted) of

* one launch a leaf (``fused_update_leaf`` per leaf, in every checkout):
  row 5, smollm-360m's mlp.wi store (32 layers of the 0.9-sparse BCSR
  data), with the prox; row 5c, LeNet-5's fc1 (800, 500) and VGG16's
  conv4-2 (3, 3, 512, 512), with the prox; a launch's floor, one leaf of
  32, 960, 2048 and 30720 elements; row 5s, one SpC step's update over
  every leaf of LeNet-5 and of ResNet-32 (the prox where the default
  predicate holds) and smollm-360m's debias tree (row 5's eleven leaf
  sizes, with the prox);
* where the checkout has the tree entry (``fused_tree_update`` over lists),
  each row-5s tree as one call; and, with ``--variants``, every row as one
  call through patched copies of the source (``VARIANTS``: vectors a
  thread, threads a block) built into ``build/prox_adam_design/``, each
  held bit-equal to the plain version first, and their ptxas reports;
* ``chip_smoke._cnn_steps``: one SpC step of each of the paper's nets at
  batch 128 on the host clock, synchronized (five steps each, sorted).

Run it for the parent (unpacked with ``git archive`` into a directory
``.gitignore`` lists, such as ``build/parent``) and the change in turns in
one call on the card: parent, change, change, parent. About a minute a run
on an H100 with the build.
"""
import json
import math
import sys
from pathlib import Path

VECS = "constexpr int VECS = 1; "
THREADS = "constexpr int THREADS = 128;"
VARIANTS = {
    # 2 / 4 float4 of each array a thread (128 / 256 B in flight)
    "v2": [(VECS, VECS.replace("1", "2"))],
    "v4": [(VECS, VECS.replace("1", "4"))],
    # 256 threads a block
    "t256": [(THREADS, THREADS.replace("128", "256"))],
}
CHUNKS = {"v2": 1024, "v4": 2048, "t256": 1024}
FLOORS = (32, 960, 2048, 30720)


def queued_calls(launches: int) -> int:
    """``chip_smoke.queued_calls`` (which an older checkout lacks): timed
    calls that queue at most 600 launches in all, so that the events time
    the device and not the host."""
    return max(1, min(100, 600 // launches))


def leaves(shapes, dev):
    """A fresh (w, g, m, v) set of f32 leaves and the prox flags."""
    return ([torch.randn(s, device=dev) for s in shapes],
            [torch.randn(s, device=dev) for s in shapes],
            [torch.randn(s, device=dev) * 0.1 for s in shapes],
            [torch.rand(s, device=dev) * 0.01 for s in shapes])


def per_leaf(prox, sc):
    def fn(ws, gs, ms, vs):
        for w, g, m, v, p in zip(ws, gs, ms, vs, prox):
            ops.fused_update_leaf(w, g, m, v, sc, apply_prox=p)
    return fn


def one_call(prox, sc):
    def fn(ws, gs, ms, vs):
        ops.fused_tree_update(ws, gs, ms, vs, sc, prox=prox)
    return fn


def main(tree: str) -> int:
    dev = torch.device("cuda", 0)
    names = [a.split("=", 1)[1] for a in sys.argv[2:]
             if a.startswith("--variants=")]
    names = [n for n in (names[0].split(",") if names else []) if n]
    cs._build.load("prox_adam")
    sc = ops.make_scalars(1e-3, cs.PROX_TAU / 1e-3, 0.9, 0.999, 1e-8, 3)
    # row 5's leaf sizes, as chip_smoke's train kernel phase makes them
    rng = np.random.default_rng(1)
    sizes = {f"bcsr_data {name}": 32 * cs._weight(rng, n, k, dev).data.numel()
             for name, (n, k) in cs.TRAIN_MATRICES}
    cfg = cs.get_config(cs.ARCH)
    sizes.update({"embedding": cfg.vocab * cfg.d_model,
                  "stacked norm": 32 * cfg.d_model,
                  "final norm": cfg.d_model, "placeholder": 32})
    trees = {"row5 mlp.wi": ([(sizes["bcsr_data mlp.wi"],)], [True])}
    for leaf, shape in cs.CNN_ADAM_LEAVES:
        trees[f"row5c {leaf}"] = ([shape], [True])
    for n in FLOORS:
        trees[f"floor n={n}"] = ([(n,)], [True])
    for name in ("lenet5", "resnet32-cifar"):
        params = cs.CNN_ZOO[name].init(torch.Generator(dev).manual_seed(0),
                                       dev)
        flat = flatten_with_path(params)
        trees[f"row5s {name}"] = (
            [p.shape for _, p in flat],
            [prox_lib.default_regularized_predicate(keystr(k), p)
             for k, p in flat])
    trees["row5s debias tree"] = ([(n,) for n in sizes.values()],
                                  [True] * len(sizes))
    has_tree = hasattr(ops, "launch_plan")
    libs = {}
    if names:
        import cuda_variants
        libs = cuda_variants.build_variants(
            "prox_adam", Path(tree) / "build" / "prox_adam_design", VARIANTS,
            names, ops._lib, ("prox_adam_tree",))
    out = {"tree": tree, "card": cs.device_phase(dev)}
    if has_tree:
        log = cs._build.log_path("prox_adam").read_text()
        out["ptxas"] = {name: [ln.strip() for ln in text.splitlines()
                               if "registers" in ln]
                        for name, text in [("shipped", log)] + [
                            (n, libs[n][1]) for n in names]}
    for what, (shapes, prox) in trees.items():
        numel = sum(math.prod(s) for s in shapes)
        sets = cs.copies(lambda: leaves(shapes, dev), 28 * numel)
        row = {"leaves": len(shapes), "numel": numel,
               "bound_ms": 28 * numel / cs.HBM_BYTES_PER_S * 1e3,
               "per_leaf_ms": [cs.time_ms(per_leaf(prox, sc), sets,
                                          queued_calls(len(shapes)))
                               for _ in range(3)]}
        if has_tree:
            if len(shapes) > 1:
                row["tree_ms"] = [cs.time_ms(one_call(prox, sc), sets)
                                  for _ in range(3)]
            row.update(design(libs, names, shapes, prox, sc, sets, dev))
        out[what] = row
        del sets
    # one SpC step of each net at batch 128, host clock (synchronized)
    out["cnn_step_ms"] = {name: r["step_ms"]
                          for name, r in cs._cnn_steps(dev).items()}
    print(json.dumps(out), flush=True)
    return 0


def design(libs, names, shapes, prox, sc, sets, dev) -> dict:
    """Each variant's tree call: held bit-equal to the plain version, then
    timed three times."""
    shipped, chunk = ops._lib, ops.CHUNK
    res = {}
    try:
        for name in names:
            lib = libs[name][0]
            ops._lib, ops.CHUNK = (lambda lib=lib: lib), CHUNKS[name]
            if lib.prox_adam_chunk() != ops.CHUNK:
                raise SystemExit(f"variant {name}: chunk "
                                 f"{lib.prox_adam_chunk()} != {ops.CHUNK}")
            ws, gs, ms, vs = leaves(shapes, dev)
            want = ops.fused_tree_update_ref(ws, gs, ms, vs, sc, prox=prox)
            one_call(prox, sc)(ws, gs, ms, vs)
            torch.cuda.synchronize()
            for got, ref in zip(zip(ws, ms, vs), want):
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise SystemExit(f"variant {name} differs from plain")
            res[f"{name}_ms"] = [cs.time_ms(one_call(prox, sc), sets)
                                 for _ in range(3)]
    finally:
        ops._lib, ops.CHUNK = shipped, chunk
    return res


if __name__ == "__main__":
    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[1] + "/tools"]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import prox as prox_lib
    from repro_torch.core.tree import flatten_with_path, keystr
    from repro_torch.kernels.prox_adam import ops
    sys.exit(main(sys.argv[1]))
