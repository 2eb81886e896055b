"""What the gloo ranks of tests/test_torch_sharded.py run.

A module of its own, without jax, because ``run_ranks`` starts each rank with
the ``spawn`` method and the rank imports the function it runs by module
name. ``run_cases`` runs every case of one world size in one spawn and returns
the numbers the test compares with the JAX package's sharded run.
"""

import torch

from cuda_gcn_torch import convert, train
from cuda_gcn_torch.ops import adam
from cuda_gcn_torch.ops.graphsum import rect_graphsum
from cuda_gcn_torch.parallel import multihost, sharded
from cuda_gcn_torch.utils.checkpoint import restore_state


def _state(cfg, params):
    """A port TrainState holding the JAX package's ``params`` (numpy), zero moments."""
    state = train.create_state(cfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    state.opt = adam.init(state.params())
    return sharded.create_state(cfg, "cpu", torch.distributed.get_rank(), state)


def _numpy(params):
    return {k: v.detach().float().numpy().copy() for k, v in params.items()}


class _Exchange(torch.autograd.Function):
    """The exchange alone, differentiated: its backward is the inverse rounds."""

    @staticmethod
    def forward(ctx, send, ex):
        ctx.ex = ex
        return ex.start(send).wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.start(g.contiguous(), inverse=True).wait(), None


def _unpaired(z, inputs, halo_dtype):
    """The JAX package's halo_graphsum as autograd of its pieces: gather,
    cast, exchange, cast back, the two rect_graphsums."""
    send = sharded._cast_payload(z[inputs.send_idx], halo_dtype)
    halo = _Exchange.apply(send, inputs.exchange).to(z.dtype)
    return rect_graphsum(z, inputs.interior) + rect_graphsum(halo, inputs.boundary)


def _case(rank, case):
    cfg, shard = case["cfg"], case["shards"][rank]
    inputs, truths = sharded.shard_inputs(cfg, shard, "cpu")
    kind = case["kind"]
    if kind == "eval":
        loss, acc = sharded.eval_step(_state(cfg, case["params"]).model, inputs,
                                      truths[case["split"]], cfg)
        return float(loss), float(acc)
    if kind == "grads":
        state = _state(cfg, case["params"])
        loss, acc = sharded.loss_and_grads(state, inputs, truths[case["split"]], cfg)
        return float(loss), float(acc), _numpy({k: p.grad for k, p in
                                               state.model.named_parameters()})
    if kind == "fused":
        state = _state(cfg, case["params"])
        m = sharded.run_epochs(state, inputs, truths[1], truths[2], cfg, case["epochs"])
        return m.numpy(), _numpy(state.params())
    if kind == "chunked":
        out = []
        for run in (sharded.run_epochs, sharded.run_epochs_chunked):
            state = _state(cfg, case["params"])
            extra = dict(chunk=case["chunk"]) if run is sharded.run_epochs_chunked else {}
            m = run(state, inputs, truths[1], truths[2], cfg, case["epochs"], **extra)
            out.append((m.numpy(), _numpy(state.params()), _numpy(state.opt.m),
                        int(state.opt.step), state.generator.get_state().numpy()))
        return out
    if kind == "pair":
        block = shard.part.block
        rows = slice(rank * block, (rank + 1) * block)
        z = torch.from_numpy(case["z"][rows]).requires_grad_()
        ct = torch.from_numpy(case["ct"][rows])
        y_pair, _ = sharded.halo_graphsum_pair(z, z.detach(), inputs, cfg.halo_dtype)
        (g_pair,) = torch.autograd.grad(y_pair, z, ct)
        y_ref = _unpaired(z, inputs, cfg.halo_dtype)
        (g_ref,) = torch.autograd.grad(y_ref, z, ct)
        y_one = sharded.halo_graphsum(z, inputs, cfg.halo_dtype)
        (g_one,) = torch.autograd.grad(y_one, z, ct)
        return [t.detach().numpy() for t in (y_pair, g_pair, y_ref, g_ref, y_one, g_one)]
    if kind == "run":
        initial = None
        if case.get("checkpoint"):
            initial = restore_state(case["checkpoint"], like=train.create_state(cfg, "cpu"))
        res = sharded.run_sharded(cfg, shard, device="cpu", verbose=False,
                                  initial_state=initial)
        return res.history, res.test_loss, res.test_acc, res.epochs_run
    raise ValueError(kind)


def run_cases(rank, world_size, init_method, cases):
    """Every case of ``cases`` ({name: case}) on this rank: {name: result}."""
    torch.set_num_threads(1)
    multihost.initialize(init_method, world_size, rank, device="cpu")
    return {name: _case(rank, case) for name, case in cases.items()}


def fail_on_rank_1(rank, world_size, init_method):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    multihost.initialize(init_method, world_size, rank, device="cpu")
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.all_reduce(torch.ones(1))
    return rank
