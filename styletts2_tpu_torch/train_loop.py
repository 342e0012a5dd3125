"""Finetune driver: CLI + epoch loop around the D/G train step, one device.

Counterpart of styletts2_tpu/train_loop.py (reference train.py:40-481):
YAML config, symbol table, duration-binned loaders, finetune only (a
pretrained checkpoint is required, train.py:170-171), per-module AdamW
with the acoustic ft_lr and freeze/ignore modules, alternating D/G
updates, loss logging every log_interval (JSONL + TensorBoard events),
the current_model autosave every 1000 iterations, per-epoch validation
and epoch checkpoints every save_freq epochs. The losses are fetched from
the device only at each log_interval (and at an epoch's end), so the
steps between run without a host sync of the loop's own. With
`slmadv_params.enabled` the SLM (WavLM) adversarial round (nn/slm.py) runs
after every `slmadv_params.iter`-th step of an epoch, its `slm_g` / `slm_d`
in that step's metrics; it needs `wavlm_path` (a local HF WavLMModel state
dict) or `allow_random_wavlm` (smoke runs only). `--profile-dir` writes a
torch.profiler trace of steps 10-14 of the first epoch. Runs on CUDA
unless `device="cpu"` is passed.

`--distributed`: data parallelism over torch.distributed, one process per
GPU as `torchrun` launches it (parallel.init_distributed reads RANK,
WORLD_SIZE and LOCAL_RANK; NCCL on CUDA, gloo on the CPU; `--dist-url`
for another rendezvous, e.g. a file:// store). Every rank loads the
checkpoint and then takes rank 0's parameters (a broadcast); the loaders
hand each rank its own disjoint share of every duration bin
(num_replicas = world size, rank); each D/G step and SLM round averages
its gradients and losses over the ranks (train.make_parallel_train_step),
so the ranks' parameters and optimizer states stay equal; validation
sums over the ranks' shares. Rank 0 alone writes checkpoints, the log
file, TensorBoard scalars and the profile trace. `tpu.dp`, when positive,
must equal the world size.

Usage: python -m styletts2_tpu_torch.train_loop -p configs/config.yaml
       torchrun --nproc-per-node N -m styletts2_tpu_torch.train_loop \
           --distributed -p configs/config.yaml
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger("styletts2_tpu_torch.train")
PROFILE_STEPS = (10, 15)  # --profile-dir traces first <= i < stop


def setup_logging(log_dir: str, write: bool = True
                  ) -> Optional[logging.Handler]:
    """Console logging, and the log file in log_dir when `write` (rank 0
    of a distributed run, or a single-process run)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(asctime)s: %(message)s")
    if not write:
        return None
    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(levelname)s:%(asctime)s: %(message)s"))
    logger.addHandler(fh)
    return fh


class MetricsWriter:
    """Scalars written twice: JSONL and a TensorBoard event file."""

    def __init__(self, log_dir: str):
        from styletts2_tpu_torch.tb_events import TBEventWriter

        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = TBEventWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "time": time.time()})
                      + "\n")
        self._f.flush()
        self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
        self._tb.close()


class Trainer:
    """What one `main` run built and did: the modules, the optimizer, the
    loaders, the step functions per duration bin, the SLM trainer (None
    unless enabled), and a record per train step (`history`: bin, step,
    metrics, and step_ms, the host's wall ms of the call and of its SLM
    round, which need not cover the device's work) and per eval batch
    (`evals`); `trace`, the --profile-dir trace's path."""

    def __init__(self, cfg, modules, opt, train_loader, val_loader, device,
                 slm=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh  # data-parallel ranks (parallel.Mesh) or None
        self.modules = modules
        self.opt = opt
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = device
        self.slm = slm
        self.trace: Optional[str] = None
        self.history: List[Dict[str, Any]] = []
        self.evals: List[Dict[str, float]] = []
        self._train: Dict[int, Any] = {}
        self._eval: Dict[int, Any] = {}

    def train_step_for(self, bin_id: int):
        """One step function per duration bin: its crop follows the
        reference's batch-min bound (train.py:235)."""
        from styletts2_tpu_torch.data.loader import bin_crop_frames
        from styletts2_tpu_torch.train import (make_parallel_train_step,
                                              make_train_step)

        if bin_id not in self._train:
            crop = bin_crop_frames(bin_id, self.cfg.max_len)
            self._train[bin_id] = (
                make_train_step(self.cfg, self.opt, crop)
                if self.mesh is None else
                make_parallel_train_step(self.cfg, self.opt, self.mesh, crop))
        return self._train[bin_id]

    def eval_step_for(self, bin_id: int):
        from styletts2_tpu_torch.data.loader import bin_crop_frames
        from styletts2_tpu_torch.train import eval_step_fn

        if bin_id not in self._eval:
            self._eval[bin_id] = eval_step_fn(
                self.cfg, crop_frames=bin_crop_frames(bin_id, self.cfg.max_len))
        return self._eval[bin_id]


def main(argv=None, device: str = "cuda") -> Trainer:
    """Run the finetune described by `-p CONFIG`; returns the Trainer.
    device: "cuda" (the default; raises when no GPU is present) or "cpu",
    which must be asked for."""
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.checkpoint import (apply_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint)
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data import build_dataloader
    from styletts2_tpu_torch.data.loader import bin_crop_frames
    from styletts2_tpu_torch.models import build_model
    from styletts2_tpu_torch.optim import MultiOptimizer
    from styletts2_tpu_torch.profiling import (StepTimer, StepTrace,
                                               check_finite)
    from styletts2_tpu_torch.text import build_symbol_dict
    from styletts2_tpu_torch.train import Batch

    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--config_path", default="configs/config.yaml")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of steps 10-14 of "
                    "the first epoch here")
    ap.add_argument("--nan-action", default="raise",
                    choices=["raise", "ignore"])
    ap.add_argument("--distributed", action="store_true",
                    help="data parallelism over torch.distributed, one "
                    "process per GPU (launch with torchrun)")
    ap.add_argument("--dist-url", default="env://",
                    help="--distributed rendezvous: env:// (torchrun's "
                    "MASTER_ADDR/MASTER_PORT) or a file:// store")
    args = ap.parse_args(argv)

    cfg = load_config(args.config_path)
    mesh = None
    if args.distributed:
        from styletts2_tpu_torch.parallel import (broadcast_module,
                                                  init_distributed, make_mesh)

        # before anything touches CUDA: this rank's GPU becomes current
        dev = init_distributed(device, init_method=args.dist_url)
        mesh = make_mesh(cfg.tpu.dp, device=dev)
    dev = mesh.device if mesh is not None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA device is available; pass "
                           "device='cpu' to train on the CPU")
    # f32 parity with the JAX package's true-f32 convs and matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    main_rank = mesh is None or mesh.rank == 0
    log_dir = cfg.log_dir
    log_handler = setup_logging(log_dir, write=main_rank)
    writer = None
    if main_rank:
        shutil.copy(args.config_path,
                    os.path.join(log_dir, os.path.basename(args.config_path)))
        writer = MetricsWriter(os.path.join(log_dir, "tensorboard"))
    replicas = (1, 0) if mesh is None else (mesh.size, mesh.rank)

    symbol_dict = build_symbol_dict(cfg.symbol)
    print(f"\nFound: {len(symbol_dict) + 1} symbols")
    with open(cfg.data_params.train_data, encoding="utf-8") as f:
        train_list = f.readlines()
    with open(cfg.data_params.val_data, encoding="utf-8") as f:
        val_list = f.readlines()
    # each rank draws its own disjoint share of every duration bin
    train_loader = build_dataloader(
        train_list, cfg.data_params.root_path, symbol_dict,
        batch_size=cfg.batch_size, debug=cfg.debug,
        num_replicas=replicas[0], rank=replicas[1])
    val_loader = build_dataloader(
        val_list, cfg.data_params.root_path, symbol_dict, validation=True,
        batch_size=cfg.batch_size, debug=cfg.debug,
        num_replicas=replicas[0], rank=replicas[1])

    if not cfg.pretrained_model:
        raise RuntimeError("Must have a pretrained!")  # train.py:170-171
    mods = build_model(cfg.model_params)
    W.split_weight_norm(mods)
    state = load_checkpoint(cfg.pretrained_model)
    apply_checkpoint(mods, state, ignore_modules=set(
        cfg.training_strats.ignore_modules) - {""})
    mods.to(dev).train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    if mesh is not None:
        broadcast_module(mesh, mods)  # every rank starts from rank 0's
    opt = MultiOptimizer(mods, lr=cfg.optimizer_params.lr,
                         ft_lr=cfg.optimizer_params.ft_lr)
    start_epoch, iters = 0, 0
    if not cfg.load_only_params and state.get("optimizer") is not None:
        opt.load_state_trees(state["optimizer"])
        start_epoch = state.get("epoch", 0)
        iters = state.get("iters", 0)
    # freeze_modules: lr 0 (AdamW's decay is scaled by lr too)
    for k in set(cfg.training_strats.freeze_modules) - {""}:
        if k in opt.opts:
            opt.set_lr(k, 0.0)
        print(f"{k} Freezed")

    slm = None
    if cfg.slmadv_params.enabled:
        from styletts2_tpu_torch.nn.slm import build_trainer

        slm = build_trainer(cfg, opt, dev, mesh)
        if mesh is not None:
            broadcast_module(mesh, slm.wl.wd)
    trainer = Trainer(cfg, mods, opt, train_loader, val_loader, dev, slm,
                      mesh)
    tracer = (StepTrace(args.profile_dir, dev, *PROFILE_STEPS)
              if args.profile_dir and main_rank else None)
    # every random draw of the steps comes from this one generator
    gen = torch.Generator(device=dev).manual_seed(1)
    best_loss = float("inf")
    timer = StepTimer()
    pending: List[Dict[str, Any]] = []  # history entries not yet fetched

    def fetch_pending() -> None:
        """One device-to-host copy of every pending step's losses, then
        the non-finite check on each."""
        if not pending:
            return
        vals = torch.stack([v.detach().float().reshape(())
                            for h in pending
                            for v in h["metrics"].values()]).tolist()
        it = iter(vals)
        for h in pending:
            h["metrics"] = {k: next(it) for k in h["metrics"]}
            check_finite(h["metrics"], h["step"], args.nan_action)
        pending.clear()

    for epoch in range(start_epoch, cfg.epochs):
        start_time = time.time()
        train_loader.sampler.set_epoch(epoch)
        for i, (bin_id, nb) in enumerate(train_loader):
            batch = Batch.from_numpy(nb, dev)
            traced = tracer is not None and epoch == start_epoch
            if traced:
                tracer.begin(i)
            t0 = time.perf_counter()
            metrics = trainer.train_step_for(bin_id)(mods, batch, gen)
            if slm is not None and (i + 1) % cfg.slmadv_params.iter == 0:
                metrics.update(slm.step(
                    mods, batch.texts, batch.input_lengths, batch.waves,
                    bin_crop_frames(bin_id, cfg.max_len), gen))
            if traced:
                tracer.end(i)
            timer.tick()
            iters += 1
            trainer.history.append(dict(
                bin=bin_id, step=iters, metrics=metrics,
                step_ms=(time.perf_counter() - t0) * 1e3))
            pending.append(trainer.history[-1])
            if (i + 1) % cfg.log_interval == 0:
                fetch_pending()
            if (i + 1) % cfg.log_interval == 0 and writer is not None:
                m = trainer.history[-1]["metrics"]
                writer.add_scalar("train/step_time_p50", timer.p50, iters)
                logger.info(
                    "Epoch [%d/%d], Step [%d], Mel: %.5f, Disc: %.5f, "
                    "Dur: %.5f, CE: %.5f, Norm: %.5f, F0: %.5f, Gen: %.5f, "
                    "S2S: %.5f, Mono: %.5f (%.2fs)",
                    epoch + 1, cfg.epochs, i + 1, m["mel"], m["d_loss"],
                    m["dur"], m["ce"], m["norm"], m["f0"], m["gen"],
                    m["s2s"], m["mono"], time.time() - start_time)
                for k, v in m.items():
                    writer.add_scalar(f"train/{k}", v, iters)
            if iters % 1000 == 0 and main_rank:
                save_checkpoint(os.path.join(log_dir, "current_model.ckpt"),
                                mods, opt.state_trees(), iters=iters,
                                epoch=epoch)

        fetch_pending()
        if tracer is not None and epoch == start_epoch:
            tracer.close()  # an epoch shorter than the window
            trainer.trace = tracer.path
        # ---------------- eval (train.py:363-463) ------------------------
        tot = {"mel": 0.0, "dur": 0.0, "f0": 0.0}
        n_eval = 0
        for bin_id, nb in val_loader:
            m = trainer.eval_step_for(bin_id)(
                mods, Batch.from_numpy(nb, dev), gen)
            m = {k: float(v) for k, v in m.items()}
            trainer.evals.append(m)
            for k in tot:
                tot[k] += m[k]
            n_eval += 1
        if mesh is not None:  # every rank's share of the validation set
            sums = torch.tensor([tot["mel"], tot["dur"], tot["f0"], n_eval],
                                dtype=torch.float64, device=dev)
            mesh.all_reduce(sums)
            tot = dict(zip(("mel", "dur", "f0"), sums[:3].tolist()))
            n_eval = int(sums[3])
        if n_eval and main_rank:
            logger.info("Validation loss: %.3f, Dur loss: %.3f, F0 loss: %.3f",
                        tot["mel"] / n_eval, tot["dur"] / n_eval,
                        tot["f0"] / n_eval)
            writer.add_scalar("eval/mel_loss", tot["mel"] / n_eval, epoch + 1)
            writer.add_scalar("eval/dur_loss", tot["dur"] / n_eval, epoch + 1)
            writer.add_scalar("eval/F0_loss", tot["f0"] / n_eval, epoch + 1)
        if n_eval:
            best_loss = min(best_loss, tot["mel"] / n_eval)

        if (epoch + 1) % cfg.save_freq == 0 and main_rank:
            save_checkpoint(
                os.path.join(log_dir, f"epoch_{epoch:05d}.ckpt"),
                mods, opt.state_trees(), iters=iters, epoch=epoch,
                val_loss=tot["mel"] / max(n_eval, 1))
            logger.info("Saving..")
    if writer is not None:
        writer.close()
    if log_handler is not None:
        logger.removeHandler(log_handler)
        log_handler.close()
    return trainer


if __name__ == "__main__":
    main()
