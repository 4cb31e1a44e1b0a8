"""Voxel-sharded fit through the USER-FACING model API, on the PyTorch port
(twin of examples/multichip_fit.py).

The mesh is a constructor argument of the model: responses, weights,
per-voxel alphas and metrics shard over the voxel axis, and the solve moves
no voxel data between shards. By default the mesh holds every card of the
machine; a mesh may repeat a device, so one card (or the CPU) can carry
several shards:

    python examples/torch_multichip_fit.py               # the cards
    python examples/torch_multichip_fit.py --device cpu  # 8 CPU entries

main() returns what it prints.
"""

import argparse

import numpy as np

# On the CPU the mesh repeats the CPU as often as the JAX example's virtual
# devices (xla_force_host_platform_device_count=8).
CPU_MESH_ENTRIES = 8


def main(argv=None, device="cuda", mesh=None):
    """Train/test and full nested-CV fits sharded over `mesh` (a 1-D voxel
    Mesh from litcoder_core_torch.parallel.make_mesh), or over every card
    (CPU_MESH_ENTRIES entries of the CPU) when None. Returns the metrics and
    best alphas of both fits."""
    from litcoder_core_torch import NestedCVModel
    from litcoder_core_torch.parallel import make_mesh
    from litcoder_core_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=device)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if mesh is None:
        mesh = make_mesh(devices=[dev] * CPU_MESH_ENTRIES
                         if dev.type == "cpu" else None)
    n = mesh.size
    print(f"{n} {mesh.devices.flat[0].type} device(s)")

    rng = np.random.default_rng(0)
    T, Tp, D, V = 600, 150, 24, 1001  # V deliberately not divisible by n
    X = rng.normal(size=(T, D)).astype(np.float32)
    wt = rng.normal(size=(D, V)).astype(np.float32)
    Y = (X @ wt + 2 * rng.normal(size=(T, V))).astype(np.float32)
    X_test = rng.normal(size=(Tp, D)).astype(np.float32)
    y_test = (X_test @ wt + 2 * rng.normal(size=(Tp, V))).astype(np.float32)

    # Single knob: the mesh (or n_devices). The solve needs no collectives.
    model = NestedCVModel(seed=0, mesh=mesh, device=dev)
    metrics, weights, best_alphas = model.fit_predict(
        X, Y, X_test=X_test, y_test=y_test,
        chunk_length=20, n_inner_folds=5,
    )
    print(f"median r = {metrics['median_score']:.3f}  "
          f"significant = {metrics['n_significant']}/{V}  "
          f"weights {tuple(weights.shape)}")

    # Full nested CV shards the same way (and runs the fused
    # outer-fold-streaming path when folds are complement-structured).
    metrics_cv, _, best_alphas_cv = model.fit_predict(
        X, Y, chunk_length=20, n_outer_folds=3, n_inner_folds=3,
    )
    print(f"full-CV median r = {metrics_cv['median_score']:.3f}")
    return {"n_devices": n, "metrics": metrics, "best_alphas": best_alphas,
            "weights_shape": tuple(weights.shape), "metrics_cv": metrics_cv,
            "best_alphas_cv": best_alphas_cv}


if __name__ == "__main__":
    main()
