"""Rank jobs of the sharded tests (tests/test_torch_spmd.py,
tests/test_torch_imports.py). Each runs in a rank process started by
`mhmocap_tpu_torch.parallel.ranks.run_ranks` and imports torch and the
port only; inputs arrive as numpy, results leave as numpy.
"""

import contextlib
import io
import os

import torch

from mhmocap_tpu_torch import convert
from mhmocap_tpu_torch.data.ingestion import SequenceArrays
from mhmocap_tpu_torch.engine import optimizer as E
from mhmocap_tpu_torch.parallel import spmd as S


def problem(p, overrides=None, stale=None):
    """(model, cfg, data, params, aux) of a payload built by the test:
    the body's arrays, the SequenceArrays fields, the EngineConfig
    fields and the init params, all numpy."""
    model = convert.smpl_model_from_numpy(p["model"])
    cfg = E.EngineConfig(**{**p["cfg"], **(overrides or {})})
    seq = SequenceArrays(**p["seq"], lagged_tn=stale)
    data = E.prepare_seq_data(seq, cfg)
    params = convert.params_from_numpy(p["params"])
    aux = E.init_aux(cfg, model.num_vertices,
                     torch.as_tensor(p["betas_ref"]))
    return model, cfg, data, params, aux


def numpy_params(params):
    return [x.detach().cpu().numpy() for x in params]


def sharded_loss(mesh, p, overrides=None, stale=None):
    """Loss, parts and the gathered gradient of one sharded cycle."""
    model, cfg, data, params, aux = problem(p, overrides, stale)
    loss, parts, grads = S.spmd_cycle_loss_and_grads(
        S.shard_params(params, mesh), model, S.shard_data(data, mesh),
        S.shard_aux(aux, mesh), p["coefs"], cfg, mesh)
    return {"loss": float(loss), "parts": parts.numpy(),
            "grads": numpy_params(S.gather_params(grads, mesh))}


def sharded_fused(mesh, p, cycles, overrides):
    """The fused cycles at the given indices from the init state: per
    cycle loss, parts and the collectives counted against their budget;
    then the gathered params, the aux and this rank's replicated
    params."""
    model, cfg, data, params, aux = problem(p, overrides)
    data, aux = S.shard_data(data, mesh), S.shard_aux(aux, mesh)
    state = S.shard_opt_state(E.rmsprop_init(params), mesh)
    params = S.shard_params(params, mesh)
    out = {"loss": [], "parts": [], "collectives": [], "budget": []}
    for c in cycles:
        mesh.reset_counts()
        params, state, aux, loss, parts = S.spmd_stage1_cycle_fused(
            params, state, aux, c, model, data, p["coefs"], cfg, mesh)
        out["collectives"].append(dict(mesh.collectives))
        out["budget"].append(S.cycle_collectives(cfg, mesh, c))
        out["loss"].append(float(loss))
        out["parts"].append(parts.numpy())
    out["params"] = numpy_params(S.gather_params(params, mesh))
    out["replicated"] = [params.betas.numpy(), params.xscale.numpy(),
                         state.nu.betas.numpy(), state.trace.xscale.numpy()]
    out["have"] = (aux.have_scene, aux.have_filters)
    out["scene_depth"] = aux.scene.depth.numpy()
    out["dvf"] = S._gather_time(mesh, [aux.verts_filt_diff])[0].float().numpy()
    return out


def cycle_job(mesh, p):
    """Everything the sharded-cycle tests read, from one set of ranks."""
    return {
        "loss": sharded_loss(mesh, p),
        "gap": sharded_loss(mesh, p, {"gap_aware_temporal": True},
                            p["stale"]),
        "fused": sharded_fused(mesh, p, p["cycles"], p["fused_cfg"]),
    }


def predictor_job(mesh, p):
    """Predictor.run on the ranks: one run into a directory of each
    rank's own (to see who writes), then 4 cycles unbroken and 2 + 2
    resumed from a checkpoint in shared directories."""
    from mhmocap_tpu_torch.engine.predictor import Predictor
    from mhmocap_tpu_torch.workload import bench_args
    model = convert.smpl_model_from_numpy(p["model"])
    seq = SequenceArrays(**p["seq"], lagged_tn=p["stale"])

    def run(out, num_iter, **extra):
        args = bench_args(num_iter, None, 16, verbose=True)
        for k, v in extra.items():
            setattr(args, k, v)
        pred = Predictor(seq, model, out, args, device="cpu")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = pred.run()
        return pred, res, printed.getvalue()

    pred, res, printed = run(os.path.join(p["tmp"], f"own{mesh.rank}"),
                             p["num_iter"], gap_aware_temporal=True)
    whole = run(os.path.join(p["tmp"], "whole"), 4)
    run(os.path.join(p["tmp"], "split"), 2, checkpoint_every=1)
    resumed = run(os.path.join(p["tmp"], "split"), 4, checkpoint_every=1)
    return {"printed": printed, "chunk": pred.cfg.chunk,
            "padded": pred.cfg.padded_frames,
            "gap": pred.cfg.gap_aware_temporal,
            "losses": pred.stage1_losses,
            "betas": numpy_params(pred._params)[2],
            "whole_losses": whole[0].stage1_losses,
            "resumed_losses": resumed[0].stage1_losses,
            "resumed_printed": resumed[2]}
