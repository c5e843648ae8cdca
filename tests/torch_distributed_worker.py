"""Worker process of the port's two-process tests (gloo, on the CPU).

Launched by ``tests/test_torch_distributed.py`` as two separate Python
processes. Each joins a ``torch.distributed`` world over gloo, reads the
cases the parent wrote to ``<dir>/inputs.npz`` and, for each, builds the
case's mesh, feeds only its own shard of the batch and runs the port's
sharded step functions: the gradients of the rate-distortion loss, the
evaluation and one ``train_step``; then the height-sharded round trip.
It writes what it got to ``<dir>/rank<id>.npz`` and prints one checksum
line a case; the parent checks that both processes printed the same and
holds the results against the single-process port and the JAX package.
Imports torch and the port only.

Usage: python torch_distributed_worker.py <coordinator> <num_processes> <process_id> <dir>
"""

import os
import sys


def _case_arrays(inputs, case):
    prefix = f"{case}|"
    return {key[len(prefix):]: inputs[key] for key in inputs.files if key.startswith(prefix)}


def _run_training_case(case, arrays, results, distributed, train_parallel):
    import numpy
    import torch

    from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import (
        state_from_jax,
        state_to_jax,
    )

    (learn_bin_widths, max_itvs, model) = (bool(arrays["flag|learn_bin_widths"]),
                                           int(arrays["flag|max_itvs"]),
                                           int(arrays["flag|model"]))
    state = state_from_jax({key[len("state|"):]: value for (key, value) in arrays.items()
                            if key.startswith("state|")})
    # (data=2, model=1): the global mesh, one device a process. (data=1,
    # model=2): the world's devices with the model axis across them.
    mesh = make_mesh(2) if model == 2 else distributed.make_global_mesh(1)
    rank = distributed.dist.get_rank()
    batch = arrays["batch"]
    per = batch.shape[0] // mesh.size("data")
    blocks = mesh.local_indices("data")
    local = numpy.concatenate([batch[d * per:(d + 1) * per] for d in blocks])
    sharded_batch = distributed.global_batch(local, mesh)
    noise = (torch.from_numpy(arrays["noise_fct"]), torch.from_numpy(arrays["noise_eae"]))
    sharded = distributed.global_state(state, mesh)
    fns = train_parallel.make_sharded_step_fns(arrays["flag|gamma"].item(), learn_bin_widths,
                                               mesh, sharded, max_itvs=max_itvs)
    (grads, grads_bw, loss) = fns["rd_gradients"](sharded, sharded_batch, noise[1])
    for (name, grad) in grads.items():
        results[f"{case}|grad|{name}"] = grad.numpy()
    if grads_bw is not None:
        results[f"{case}|grad_bw"] = grads_bw.numpy()
    results[f"{case}|loss"] = loss.numpy()
    (scaled_ae, rec_error, y) = fns["evaluation"](sharded, sharded_batch, noise[0])
    results[f"{case}|eval_ae"] = scaled_ae.numpy()
    results[f"{case}|eval_rec"] = rec_error.numpy()
    results[f"{case}|eval_y"] = y.numpy()
    stepped = fns["train_step"](sharded, sharded_batch, noise)
    results[f"{case}|held_rows"] = numpy.asarray(stepped.bin_widths.shape[0])
    whole = distributed.fetch_replicated(stepped, mesh)
    for (key, value) in state_to_jax(whole).items():
        results[f"{case}|state|{key}"] = value
    checksum = float(sum(numpy.abs(v.numpy()).astype(numpy.float64).sum()
                         for v in whole.params.values()))
    checksum_bw = float(numpy.abs(whole.bin_widths.numpy()).astype(numpy.float64).sum())
    assert distributed.agree_across_processes(numpy.float64(checksum))
    print(f"CHECKSUM {case} {checksum:.10e} {checksum_bw:.10e} rank {rank}", flush=True)


def _run_spatial_case(case, arrays, results, distributed):
    import numpy

    from autoencoder_based_image_compression_tpu_torch.parallel.inference import (
        roundtrip_batched,
    )
    from autoencoder_based_image_compression_tpu_torch.parallel.mesh import make_mesh
    from autoencoder_based_image_compression_tpu_torch.train.checkpoint import params_from_jax

    learn_bin_widths = bool(arrays["flag|learn_bin_widths"])
    params = params_from_jax({key[len("param:"):]: value for (key, value) in arrays.items()
                              if key.startswith("param:")})
    mesh = make_mesh(2)  # (data=1, model=2): each process holds one band of every image
    got = roundtrip_batched(params, arrays["images"], arrays["bin_widths"], learn_bin_widths,
                            batch_size=arrays["images"].shape[0], mesh=mesh, spatial=True)
    results[f"{case}|reconstructions"] = got
    checksum = float(numpy.abs(got).astype(numpy.float64).sum())
    print(f"CHECKSUM {case} {checksum:.10e} rank {distributed.dist.get_rank()}", flush=True)


def main():
    (coordinator, num_processes, process_id, directory) = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy
    import torch

    torch.set_num_threads(2)
    from autoencoder_based_image_compression_tpu_torch.parallel import (
        distributed,
        train_parallel,
    )

    distributed.initialize(coordinator, num_processes, process_id,
                           initialization_timeout=120, device="cpu")
    assert distributed.dist.get_world_size() == num_processes
    inputs = numpy.load(os.path.join(directory, "inputs.npz"))
    cases = sorted({key.split("|")[0] for key in inputs.files})
    results = {}
    for case in cases:
        arrays = _case_arrays(inputs, case)
        if case.startswith("spatial"):
            _run_spatial_case(case, arrays, results, distributed)
        else:
            _run_training_case(case, arrays, results, distributed, train_parallel)
    numpy.savez(os.path.join(directory, f"rank{process_id}.npz"), **results)
    distributed.shutdown()


if __name__ == "__main__":
    main()
