"""Training command of the port (counterpart of the root ``train.py``, the
same flags):

    python -m speechmix_tpu_torch.train --HFSpeechMixEED \
        --speech_model_config wav2vec2-base --nlp_model_config bart-base \
        --down_scale 2 --bf16 --synthetic --batch 16 --grad_accum 1 \
        --max_steps 100 --output_dir ./out

Runs on the card; ``--platform cpu`` runs on the CPU instead (the card is
asked for by default, and the command raises when CUDA is absent).
Pass-through ``--key value`` pairs go to the model class, as in the root
script.  The model's parameters seed a TrainState of float32 master
weights (a bf16 model's matrices upcast), ``Trainer.fit`` trains them, and
the result is written as ``final_weights.npz`` in the JAX package's npz
layout, which either package's ``load_weights`` reads.

Over a mesh, one process per card:

    torchrun --nproc_per_node 4 -m speechmix_tpu_torch.train \
        --HFSpeechMixEED --model_parallel 2 --zero1 --bf16 --synthetic ...

Each rank joins the process group torchrun describes (NCCL on the card,
gloo with ``--platform cpu``), takes cuda:LOCAL_RANK, and sits in the mesh
of ``--model_parallel`` x ``--sequence_parallel`` model and seq ranks and
the world over them data ranks; each keeps its data rank's rows of every
global batch (the ``--multihost`` data path, on whenever there is more
than one rank), ``--zero1`` shards the optimizer state over the data ranks,
and only rank 0 logs and writes npz files (``--checkpoint_backend orbax``:
every rank writes its shards, in the port's own format).  The JAX compile
cache has no counterpart; ``--flash_attention`` is accepted and ignored
(the port runs its attention kernels whenever its tensors are on the
card).
"""

import argparse
import os
import sys

MODEL_FLAGS = [
    "SpeechMixEED", "SpeechMixED", "SpeechMixSelf", "SpeechMixAdapter",
    "SpeechMixGAN", "SpeechMixFixed", "HFSpeechMixEED", "HFSpeechMixED",
    "HFSpeechMixSelf", "HFSpeechMixAdapter", "HFSpeechMixGAN",
    "HFSpeechMixFixed",
]


def parse_args(args):
    parser = argparse.ArgumentParser()
    parser.add_argument("--speech_model_config", type=str)
    parser.add_argument("--nlp_model_config", type=str)
    for flag in MODEL_FLAGS:
        parser.add_argument(f"--{flag}", action="store_true")
    parser.add_argument("--cache", action="store_true")
    parser.add_argument("--dataset", type=str)
    parser.add_argument("--prompt", type=str)
    parser.add_argument("--field", type=str)
    parser.add_argument("--train_split", type=str)
    parser.add_argument("--test_split", type=str)
    parser.add_argument("--notes", type=str)
    parser.add_argument("--grad_accum", default=3, type=int)
    parser.add_argument("--logging_steps", default=10, type=int)
    parser.add_argument("--warmup_steps", default=500, type=int)
    parser.add_argument("--unfreeze_warmup_steps", default=None, type=int,
                        help="reference-quirk alias: when given it "
                             "OVERRIDES --freeze_epochs (the gradual-"
                             "unfreeze window, in epochs)")
    parser.add_argument("--save_total_limit", default=2, type=int)
    parser.add_argument("--checkpoint_backend", default="npz",
                        choices=["npz", "orbax"],
                        help="npz: the JAX package's files of the whole "
                             "state; orbax: each rank its shards "
                             "(torch.distributed.checkpoint, the port's "
                             "own files)")
    parser.add_argument("--max_grad_norm", default=10, type=float)
    parser.add_argument("--worker", default=10, type=int,
                        help="host-side data-prep thread count (CSV/audio "
                             "load + resample, tokenize)")
    parser.add_argument("--batch", type=int, default=3)
    parser.add_argument("--epoch", default=1000, type=int)
    parser.add_argument("--lr", type=float, default=4e-5)
    parser.add_argument("--lr_scheduler", default="linear",
                        choices=["linear", "cosine", "constant"],
                        help="post-warmup LR decay (decaying schedules need "
                             "--max_steps)")
    parser.add_argument("--eval_step", default=700, type=int)
    parser.add_argument("--share_layer_ratio", default=0, type=float)
    parser.add_argument("--down_scale", default=8, type=int)
    parser.add_argument("--weighted_sum", action="store_true")
    parser.add_argument("--fixed_parameters", action="store_true")
    parser.add_argument("--custom_set", type=str)
    parser.add_argument("--max_input_length_in_sec", default=20, type=int)
    # True = bucketed static-shape padding, False pads every batch to the
    # largest bucket
    parser.add_argument("--group_by_length", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--dropout", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="training-mode dropout at the HF placements "
                             "(rates from the model configs)")
    parser.add_argument("--multihost", action="store_true",
                        help="each process keeps its data rank's rows of "
                             "every global batch (on whenever the command "
                             "runs as several ranks)")
    parser.add_argument("--fixed_except", nargs="+",
                        default=["layer_norm", "encoder_attn",
                                 "enc_to_dec_proj", "length_adapter",
                                 "layernorm_embedding", "attention",
                                 "encoder"])
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="model (tensor-parallel) ranks of the mesh")
    parser.add_argument("--sequence_parallel", default=1, type=int,
                        help="seq ranks of the mesh (the speech encoder's "
                             "time axis, ring attention)")
    parser.add_argument("--optimizer", default="adafactor",
                        choices=("adafactor", "adamw"))
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: the optimizer state sharded over "
                             "the data ranks")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--freeze_epochs", default=3, type=int)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (offline smoke runs)")
    parser.add_argument("--max_steps", default=0, type=int)
    parser.add_argument("--flash_attention", default=None,
                        action=argparse.BooleanOptionalAction,
                        help="accepted and ignored: the port's attention "
                             "kernels run whenever the tensors are on the "
                             "card")
    parser.add_argument("--stall_timeout", default=0.0, type=float,
                        help="failure detection: exit 98 if no train-loop "
                             "heartbeat for this many seconds (restart "
                             "resumes from the latest checkpoint). 0 "
                             "disables")
    parser.add_argument("--load_best_model_at_end", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="restore the best-eval_loss checkpoint when "
                             "training ends; only evaluated steps are "
                             "candidates")
    parser.add_argument("--num_beams", default=1, type=int,
                        help="beam width for --predict_with_generate")
    parser.add_argument("--predict_with_generate", action="store_true",
                        help="also run free-running generate() + WER/CER at "
                             "each eval")
    parser.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                        help="cpu: run on the CPU; default and gpu: the "
                             "card")

    input_args, model_arg = parser.parse_known_args(args)
    other = {k.replace("--", ""): _coerce(v)
             for k, v in zip(model_arg[:-1:2], model_arg[1::2])}
    return input_args, other


def _coerce(v):
    """Pass-through kwargs arrive as strings; interpret the obvious
    literals (so --fixed_speech False is False)."""
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def pick_model(input_args, other):
    from speechmix_tpu_torch import api

    name = next((f for f in MODEL_FLAGS if getattr(input_args, f)),
                "SpeechMixEED")
    cls = getattr(api, name)
    kwargs = dict(
        speech_model_config=input_args.speech_model_config or "wav2vec2",
        nlp_model_config=input_args.nlp_model_config or "facebook/bart-base",
        share_layer_ratio=input_args.share_layer_ratio,
        down_scale=input_args.down_scale,
        weighted_sum=input_args.weighted_sum,
        fixed_parameters=input_args.fixed_parameters,
        fixed_except=input_args.fixed_except,
        seed=input_args.seed,
        dtype="bfloat16" if (input_args.bf16 or input_args.fp16)
        else "float32",
        device="cpu" if input_args.platform == "cpu" else None,
    )
    kwargs.update(other)
    return name, cls(**kwargs)


def main(arg=None):
    input_args, other = parse_args(sys.argv[1:] if arg is None else arg)
    import torch
    from speechmix_tpu_torch.data.datasets import build_datasets
    from speechmix_tpu_torch.parallel import mesh as mesh_lib
    from speechmix_tpu_torch.training import trainer as trainer_lib
    from speechmix_tpu_torch.training.trainer import (TrainConfig, Trainer,
                                                      TrainState)

    if _world_size() > 1:
        mesh_lib.initialize_distributed(
            backend="gloo" if input_args.platform == "cpu" else None)
        if input_args.platform != "cpu":
            other.setdefault("device",
                             f"cuda:{os.environ.get('LOCAL_RANK', 0)}")
        input_args.multihost = True
    model_type, model = pick_model(input_args, other)
    mesh = None
    if _world_size() > 1 or input_args.model_parallel > 1 or \
            input_args.sequence_parallel > 1:
        mesh = mesh_lib.make_mesh(n_model=input_args.model_parallel,
                                  n_seq=input_args.sequence_parallel,
                                  device=model.device)
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        print(f"model: {model_type} "
              f"speech_layers={model.speech_encoder_layer} "
              f"nlp_layers={model.nlp_encoder_layer} "
              f"trainable={len(model.list_grad)} "
              f"frozen={len(model.list_no_grad)}")

    train_iter, eval_iter = build_datasets(input_args, model,
                                           device=model.device, mesh=mesh)

    out_dir = input_args.output_dir or (
        f"./{(input_args.speech_model_config or 'wav2vec2').replace('/', '_')}"
        f"_{(input_args.nlp_model_config or 'bart').replace('/', '_')}"
        f"_{model_type}_{input_args.notes or ''}")

    tc = TrainConfig(
        learning_rate=input_args.lr,
        lr_schedule=input_args.lr_scheduler,
        warmup_steps=input_args.warmup_steps,
        max_grad_norm=input_args.max_grad_norm,
        grad_accum=input_args.grad_accum,
        num_epochs=input_args.epoch,
        eval_steps=input_args.eval_step,
        logging_steps=input_args.logging_steps,
        save_total_limit=input_args.save_total_limit,
        freeze_epochs=(input_args.unfreeze_warmup_steps
                       if input_args.unfreeze_warmup_steps is not None
                       else input_args.freeze_epochs),
        max_steps=input_args.max_steps,
        output_dir=out_dir,
        seed=input_args.seed,
        bf16=input_args.bf16 or input_args.fp16,
        optimizer=input_args.optimizer,
        zero1=input_args.zero1,
        model_parallel=input_args.model_parallel,
        sequence_parallel=input_args.sequence_parallel,
        wandb=input_args.wandb,
        # keep the optimizer's trainable mask in lockstep with the model's
        # freezing bookkeeping (SpeechMixFixed fixed_speech/fixed_nlp kwargs)
        fixed_speech=bool(other.get("fixed_speech", False)),
        fixed_nlp=bool(other.get("fixed_nlp", True)),
        predict_with_generate=input_args.predict_with_generate,
        num_beams=input_args.num_beams,
        load_best_model_at_end=input_args.load_best_model_at_end,
        stall_timeout_s=input_args.stall_timeout,
        dropout=input_args.dropout,
        checkpoint_backend=input_args.checkpoint_backend,
    )

    trainer = Trainer(model.config, tc, tokenizer=model.tokenizer,
                      device=model.device, mesh=mesh)
    # float32 master weights from the constructed model's parameters
    params = trainer_lib.tree_map(
        lambda p: p.detach().to(torch.float32).clone(), model.params)
    state = TrainState(params=params,
                       opt_state=trainer_lib.make_optimizer(tc).init(params),
                       step=0)
    if mesh is not None:
        state = trainer_lib.shard_train_state(state, mesh, model.config, tc)
    state = trainer.fit(state, train_iter, eval_iter)
    if mesh is not None:   # the whole parameters, gathered on every rank
        from speechmix_tpu_torch.training import sharded
        state = sharded.full_state(state, trainer._layout,
                                   trainer._optimizer)
    if rank0:
        model.params = trainer_lib.tree_map(
            lambda p: p.to(model.device), state.params)
        model.save_weights(os.path.join(out_dir, "final_weights.npz"))
        print(f"saved final weights to {out_dir}/final_weights.npz")


if __name__ == "__main__":
    main()
