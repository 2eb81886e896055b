"""Command-line entry point of the port, with the flags of cuda_gcn_tpu.cli.

    python -m cuda_gcn_torch.cli <name> [num_nodes input_dim hidden_dim output_dim dropout
                                         learning_rate weight_decay epochs early_stopping]
        [--num-nodes N ... --early-stopping N]  (each override as a flag; the flag wins)
        [--device cpu] [--data-dir data] [--seed S]
        [--backend auto|bsr|segment|ell|pallas|dense] [--feature-matmul dense|sparse]
        [--compute-dtype float32|bfloat16] [--mesh N] [--halo-dtype bfloat16|float32]
        [--save-checkpoint PATH] [--load-checkpoint PATH]
        [--metrics-csv PATH] [--metrics-jsonl PATH] [--timing] [--build-kernels]
        [--platform cpu|tpu] [--compilation-cache DIR] [--prime-cache]
        [--model gcn|gat|gcnii]

The nine hyperparameter overrides are those of the reference's usage string
(src/main.cpp:15-49), positional or as flags, as cuda_gcn_tpu.cli takes them
(:24-27,75-103). ``num_nodes``, ``input_dim`` and ``output_dim`` come from the
dataset: passing them prints a note and changes nothing; a value that does
not parse exits with its message.

A name of ``data.synthetic.PROFILES`` or ``VARIANTS`` (``synth-cora`` ...
``synth-reddit32x``, ``synth-reddit-slope``) is generated with the run's seed,
``make_synthetic(name, seed=--seed)``, as cuda_gcn_tpu.cli does (:114-118), and
the CLI prints that CLI's line "Generated synthetic dataset <name>.". At seed 0
the generator's output is read from ``.cache/<name>.npz`` when that file exists
(the cache holds ``make_synthetic(name, seed=0)``, bench.py:62-71). Any other
name is read from ``<data-dir>/<name>.{graph,split,svmlight}`` by
data/parser.py (:119-129). The output follows that CLI's contract. The bsr
backend relabels the dataset with the cached locality permutation
``.cache/<name>.perm.npy`` only when the dataset is that cached seed-0 graph,
and computes the permutation (LPA, data/reorder.py) for any other.
``--feature-matmul sparse`` keeps the layer-0 features in CSR, as the reference
program does; ``--compute-dtype bfloat16`` runs the activations in bf16.

``--save-checkpoint``/``--load-checkpoint`` write and read the JAX package's
npz layout (utils/checkpoint.py); ``--metrics-csv``/``--metrics-jsonl`` dump
the per-epoch history (utils/logging.py); ``--timing`` prints every phase
timer's average, the per-op phases measured after the run
(utils/profiling.py). ``--build-kernels`` builds the CUDA kernels and exits.

The JAX CLI's compile flags (cuda_gcn_tpu/cli.py:51-75, 133-156):
``--prime-cache`` builds what a run loads and keeps across processes, the
nvcc kernel libraries (on the card) and the g++ host libraries
(train.prime_cache), prints ``primed <library> in <s>s`` for each and ``primed
N programs in <s>s``, and exits 0 without training; the CUDA graphs of the
epoch are captured by each run and are not primed. With ``--mesh`` it exits
1, as the JAX CLI does. ``--compilation-cache DIR`` is the directory those
libraries are built into and loaded from (utils/compile_cache.py; by default
``build/`` at the repository root, and ``''`` a temporary directory).
``--platform cpu`` is ``--device cpu``; ``--platform tpu`` exits 1: the port
runs on an NVIDIA GPU.

``--mesh N`` trains sharded (parallel/sharded.py): the dataset is partitioned
once here, and N local ranks are started with ``torch.multiprocessing``'s
``spawn`` method, rank r on ``cuda:r`` over NCCL, or with ``--device cpu`` N
gloo ranks on the CPU. With fewer cards than N it exits with the JAX CLI's
message (cuda_gcn_tpu/cli.py:166-170). Rank 0 alone prints, saves and
writes the history; ``--halo-dtype`` is the wire type of the halo rows.

``--model gat`` trains the graph attention network (models/gat.py) in place
of the GCN, with the paper's transductive settings (arXiv:1710.10903, §3.3)
where the command gives none: 8 features a head (``hidden_dim``), dropout 0.6,
learning rate 0.005; its heads (8 a hidden layer, 1 on the output layer),
attention dropout (0.6) and LeakyReLU slope (0.2) are ``GCNConfig``'s
defaults. It runs on the ``ell`` backend ('auto' picks it; another is refused), single
device (``--mesh`` exits 1), without ``--timing``'s per-op phases.

``--model gcnii`` trains GCNII (models/gcnii.py) with its paper's
semi-supervised settings (arXiv:2007.02133, §6.1, the defaults of its
released code) where the command gives none: a width of 64 (``hidden_dim``),
dropout 0.6, learning rate 0.01, L2 5e-4 on the dense layers; its 64 layers,
α = 0.1, λ = 0.5 and the convolutions' L2 0.01 are ``GCNConfig``'s defaults.
It runs as the GAT does: on ``ell`` ('auto' picks it), single device, without
``--timing``. A model runs sharded where its class declares it (``shards``:
the GCN alone), which ``--mesh`` and the sharded trainer both read.

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from cuda_gcn_torch.config import GCNConfig

_POSITIONAL = ["num_nodes", "input_dim", "hidden_dim", "output_dim", "dropout",
               "learning_rate", "weight_decay", "epochs", "early_stopping"]
_PARSER_INFERRED = {"num_nodes", "input_dim", "output_dim"}
_FLOAT_FIELDS = {"dropout", "learning_rate", "weight_decay"}
# A model's settings where the command gives none: ``--model gat``'s (arXiv:1710.10903,
# §3.3) and ``--model gcnii``'s (arXiv:2007.02133, §6.1, its released code's train.py:
# the width of 64, dropout 0.6, learning rate 0.01, L2 5e-4 on the dense layers)
MODEL_DEFAULTS = {"gat": {"hidden_dim": 8, "dropout": 0.6, "learning_rate": 0.005},
                  "gcnii": {"hidden_dim": 64, "dropout": 0.6, "learning_rate": 0.01,
                            "weight_decay": 5e-4}}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_gcn_torch",
                                description="Full-batch GCN training on an NVIDIA GPU.")
    p.add_argument("graph_name", help="dataset name under --data-dir, or a synthetic "
                                      "profile, e.g. synth-reddit")
    p.add_argument("overrides", nargs="*", metavar="HP",
                   help=f"positional hyperparameter overrides, in order: {' '.join(_POSITIONAL)}")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "segment", "ell", "pallas", "dense", "bsr"])
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--halo-dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="wire type of --mesh halo rows (bf16 halves the bytes of "
                        "every exchange; float32 for the single-device result)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="train sharded over N local ranks (graph partition + halo "
                        "exchange over torch.distributed): rank r on cuda:r over NCCL, "
                        "or gloo ranks on the CPU with --device cpu")
    p.add_argument("--feature-matmul", default="dense", choices=["dense", "sparse"],
                   help="layer-0 feature transform: densified X, or the CSR values "
                        "(reference SparseMatmul)")
    p.add_argument("--save-checkpoint", default=None, metavar="PATH",
                   help="save the final train state to PATH (npz, the JAX package's layout)")
    p.add_argument("--load-checkpoint", default=None, metavar="PATH",
                   help="initialize the train state from PATH before training")
    p.add_argument("--metrics-csv", default=None, metavar="PATH",
                   help="write the per-epoch history as CSV")
    p.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="write the per-epoch history as JSONL (with run metadata)")
    p.add_argument("--timing", action="store_true",
                   help="print the phase-timer averages after the run, the per-op "
                        "phases measured on the device (the reference's "
                        "PRINT_TIMER_AVERAGE, src/common/timer.h:26)")
    p.add_argument("--build-kernels", action="store_true",
                   help="build the CUDA kernels, print the seconds and exit")
    p.add_argument("--platform", default=None, choices=["tpu", "cpu"],
                   help="'cpu' is --device cpu; the port has no TPU platform")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="directory the kernel and host libraries are built into and "
                        "loaded from (default: build/ at the repository root; '' a "
                        "temporary directory)")
    p.add_argument("--prime-cache", action="store_true",
                   help="build the libraries this run loads (nvcc kernels on the card, "
                        "g++ host code) and exit without training (train.prime_cache)")
    p.add_argument("--model", default="gcn", choices=["gcn", "gat", "gcnii"],
                   help="the network: the GCN, the graph attention network "
                        "(arXiv:1710.10903) or GCNII (arXiv:2007.02133), each of the "
                        "last two with its paper's settings as defaults")
    for name in _POSITIONAL:
        typ = float if name in _FLOAT_FIELDS else int
        p.add_argument(f"--{name.replace('_', '-')}", type=typ, default=None)
    return p


def config_from_args(args: argparse.Namespace) -> GCNConfig:
    """The run's config: the flags, then the positional overrides, each
    ``--flag`` form winning over its positional (cuda_gcn_tpu/cli.py:82-103)."""
    cfg = GCNConfig(seed=args.seed, graphsum_backend=args.backend,
                    compute_dtype=args.compute_dtype, halo_dtype=args.halo_dtype,
                    feature_matmul=args.feature_matmul, model=args.model)
    updates: dict = dict(MODEL_DEFAULTS.get(args.model, {}))
    for name, value in zip(_POSITIONAL, args.overrides):
        typ = float if name in _FLOAT_FIELDS else int
        try:
            updates[name] = typ(value)
        except ValueError:
            raise SystemExit(f"invalid value for {name}: {value!r} (expected {typ.__name__})")
    for name in _POSITIONAL:
        flag_val = getattr(args, name)
        if flag_val is not None:
            updates[name] = flag_val
    ignored = sorted(_PARSER_INFERRED & updates.keys())
    if ignored:
        print(f"note: {', '.join(ignored)} are inferred from the dataset; override ignored",
              file=sys.stderr)
        for name in ignored:
            updates.pop(name)
    return dataclasses.replace(cfg, **updates)


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    if len(args.overrides) > len(_POSITIONAL):
        print(f"too many positional overrides (max {len(_POSITIONAL)})", file=sys.stderr)
        return 1
    cfg = config_from_args(args)
    if args.platform == "tpu":
        print("--platform tpu: this port runs on an NVIDIA GPU (--device cuda) or the "
              "CPU (--platform cpu)", file=sys.stderr)
        return 1
    if args.platform == "cpu":
        args.device = "cpu"
    if args.compilation_cache is not None:
        from cuda_gcn_torch.utils.compile_cache import use_build_dir

        use_build_dir(args.compilation_cache)

    from cuda_gcn_torch import train
    from cuda_gcn_torch.data.dataset import (CACHE_DIR, cached_permutation_path,
                                             load_cached, reorder_cached)
    from cuda_gcn_torch.data.parser import load_dataset
    from cuda_gcn_torch.data.synthetic import PROFILES, VARIANTS, make_synthetic
    from cuda_gcn_torch.device import resolve_device

    if args.build_kernels:
        from cuda_gcn_torch import kernels

        resolve_device("cuda")  # the kernels are the card's: raises without one
        t0 = time.perf_counter()
        built = kernels.build()
        print(f"built {len(built)} kernel sources ({', '.join(sorted(built)) or 'all cached'}) "
              f"in {time.perf_counter() - t0:.1f}s")
        return 0

    device = resolve_device(args.device)
    name = args.graph_name
    reorder = "auto"
    cached = False
    if name in PROFILES or name in VARIANTS:
        cached = cfg.seed == 0 and os.path.exists(os.path.join(CACHE_DIR, f"{name}.npz"))
        dataset = load_cached(name) if cached else make_synthetic(name, seed=cfg.seed)
        print(f"Generated synthetic dataset {name}.")
    else:
        try:
            dataset = load_dataset(name, data_dir=args.data_dir)
        except FileNotFoundError as e:
            print(f"Cannot read input: {name} ({e})", file=sys.stderr)
            return 1
        print("Parse Graph Succeeded.")
        print("Parse Node Succeeded.")
        print("Parse Split Succeeded.")
    platform = device.type.upper()
    if args.prime_cache:
        print(f"RUNNING ON {platform}")
        if args.mesh:
            print("--prime-cache is single-chip (the sharded path compiles "
                  "per-mesh programs)", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        built = train.prime_cache(cfg, dataset, device)
        print(f"primed {len(built)} programs in {time.perf_counter() - t0:.1f}s")
        return 0
    if args.mesh:
        print(f"RUNNING ON {platform}")
        if not train.model_class(cfg).shards:
            print(f"--mesh trains the GCN; --model {cfg.model} is single-device",
                  file=sys.stderr)
            return 1
        return _run_mesh(args, cfg, dataset, device, platform)
    if cfg.model != "gcn" and args.timing:
        print(f"--timing's per-op phases are the GCN's; --model {cfg.model} has none",
              file=sys.stderr)
        return 1
    backend = train.model_class(cfg).graph_backend(cfg.graphsum_backend, dataset.num_nodes)
    if backend == "bsr" and cached and os.path.exists(cached_permutation_path(name)):
        dataset, reorder = reorder_cached(dataset, name), "none"
    print(f"RUNNING ON {platform}")
    run_cfg = dataclasses.replace(cfg, graphsum_backend=backend, reorder=reorder)

    initial_state = None
    if args.load_checkpoint:
        from cuda_gcn_torch.utils.checkpoint import restore_state

        template = train.create_state(dataset.apply_config(run_cfg), device)
        initial_state = restore_state(args.load_checkpoint, like=template)
        print(f"restored checkpoint from {args.load_checkpoint}")
    result = train.run(run_cfg, dataset, device=device, verbose=True,
                       initial_state=initial_state, time_ops=args.timing)
    _write_outputs(args, cfg, result, platform)
    return 0


def _write_outputs(args, cfg: GCNConfig, result, platform: str) -> None:
    """The checkpoint, the history files and the timers' report a run asks for."""
    if args.save_checkpoint:
        from cuda_gcn_torch.utils.checkpoint import save_state

        save_state(args.save_checkpoint, result.state)
        print(f"checkpoint saved to {args.save_checkpoint}")
    if args.metrics_csv or args.metrics_jsonl:
        from cuda_gcn_torch.utils.logging import write_history_csv, write_history_jsonl

        if args.metrics_csv:
            write_history_csv(args.metrics_csv, result.history)
        if args.metrics_jsonl:
            meta = dict(dataset=args.graph_name, seed=cfg.seed, backend=cfg.graphsum_backend,
                        platform=platform, test_loss=result.test_loss,
                        test_acc=result.test_acc, total_train_time=result.total_train_time)
            write_history_jsonl(args.metrics_jsonl, result.history, run_meta=meta)
    if args.timing:
        from cuda_gcn_torch.utils.timer import timers

        print(timers.report())


def _run_mesh(args, cfg: GCNConfig, dataset, device, platform: str) -> int:
    """Partition here, train on ``args.mesh`` spawned ranks (``_mesh_rank``)."""
    import torch

    from cuda_gcn_torch.parallel import multihost, sharded

    if device.type == "cuda" and args.mesh > torch.cuda.device_count():
        print(f"--mesh {args.mesh} needs {args.mesh} devices, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.timing:
        print("note: --timing reports only train/test phases with --mesh "
              "(per-op timers are single-chip)", file=sys.stderr)
    cfg, shards, _ = sharded.prepare_sharded(cfg, dataset, args.mesh, device=device)
    print(f"SHARDED over {args.mesh} devices (graph partition + halo exchange)", flush=True)
    multihost.run_ranks(_mesh_rank, args.mesh, (args, cfg, device.type, platform),
                        rank_args=[(s,) for s in shards])
    return 0


def _mesh_rank(rank: int, world_size: int, init_method: str, args, cfg: GCNConfig,
               device_type: str, platform: str, shard) -> None:
    """One rank of ``--mesh``: NCCL on cuda:<rank>, or gloo on the CPU (the
    host's cores split among the ranks); rank 0 prints and writes."""
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.parallel import multihost, sharded

    device = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    multihost.initialize(init_method, world_size, rank, device=device)
    initial_state = None
    if args.load_checkpoint:
        from cuda_gcn_torch.utils.checkpoint import restore_state

        initial_state = restore_state(args.load_checkpoint,
                                      like=train.create_state(cfg, device))
        if multihost.is_primary():
            print(f"restored checkpoint from {args.load_checkpoint}")
    result = sharded.run_sharded(cfg, shard, device=device, verbose=True,
                                 initial_state=initial_state)
    if multihost.is_primary():
        _write_outputs(args, cfg, result, platform)
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
