"""Checkpoint-load + generate() eval command of the port (counterpart of
the root ``eval.py``, the same flags and modes):

    python -m speechmix_tpu_torch.eval --weights ./out/final_weights.npz \
        --speech_model_config wav2vec2-base --nlp_model_config bart-base \
        --down_scale 2 --max_length 250 [--beam 4]

Modes: ``--hf_checkpoint_dir`` loads a reference fused checkpoint;
``--librispeech_dir`` transcribes a LibriSpeech split through
TranscriptionPipeline and prints corpus WER / CER; ``--synthetic_eval N``
decodes N synthetic examples through Trainer.predict and prints its JSON;
otherwise one utterance (``--audio``, or the synthetic corpus's first) is
decoded by generate with every sampling, beam and processor keyword.
``--weights`` reads the npz files either package writes.

Runs on the card; ``--platform cpu`` runs on the CPU instead (the card is
asked for by default, and the command raises when CUDA is absent).  The
model computes in float32, as the root script's does.
"""

import argparse
import json
import sys

import numpy as np


def parse_args(args):
    p = argparse.ArgumentParser()
    p.add_argument("--speech_model_config", default="wav2vec2-base")
    p.add_argument("--nlp_model_config", default="bart-base")
    p.add_argument("--weights", default=None)
    p.add_argument("--hf_checkpoint_dir", default=None,
                   help="reference FUSED checkpoint dir (composite "
                        "config.json + pytorch_model.bin, the "
                        "voidful/speechmix_eed_fixed layout): architecture "
                        "derived from config.json, weights converted")
    p.add_argument("--librispeech_dir", default=None,
                   help="LibriSpeech split dir (e.g. .../test-clean): "
                        "decode every utterance, print corpus WER/CER")
    p.add_argument("--audio", default=None, help="wav file to transcribe")
    p.add_argument("--prompt", default=None)
    p.add_argument("--max_length", default=250, type=int)
    p.add_argument("--max_new_tokens", default=None, type=int,
                   help="HF generate max_new_tokens: number of generated "
                        "tokens; takes precedence over --max_length")
    p.add_argument("--do_sample", action="store_true",
                   help="ancestral sampling instead of greedy/beam ranking")
    p.add_argument("--temperature", default=1.0, type=float)
    p.add_argument("--top_k", default=0, type=int)
    p.add_argument("--top_p", default=1.0, type=float)
    p.add_argument("--typical_p", default=1.0, type=float,
                   help="typical-decoding mass (requires --do_sample)")
    p.add_argument("--encoder_no_repeat_ngram_size", default=0, type=int,
                   help="HF kwarg, accepted for parity: with a waveform "
                        "encoder input this is a no-op")
    p.add_argument("--min_length", default=0, type=int,
                   help="EOS is suppressed until this many tokens are "
                        "generated (HF generate's min_length - 1)")
    p.add_argument("--beam", default=1, type=int)
    p.add_argument("--num_beam_groups", default=1, type=int,
                   help="diverse (group) beam search")
    p.add_argument("--diversity_penalty", default=0.0, type=float)
    p.add_argument("--kv_int8", action="store_true",
                   help="int8 cross-attention KV in the decode loop")
    p.add_argument("--share_layer_ratio", default=0, type=float)
    p.add_argument("--down_scale", default=8, type=int)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="cpu: run on the CPU; default and gpu: the card")
    p.add_argument("--synthetic_eval", default=0, type=int,
                   help="decode N held-out synthetic examples and print "
                        "corpus WER/CER")
    p.add_argument("--seed", default=1, type=int,
                   help="synthetic_eval corpus seed (the train command "
                        "uses seed+1 for its eval split)")
    p.add_argument("--batch", default=8, type=int)
    return p.parse_args(args)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = "cpu" if args.platform == "cpu" else None

    from speechmix_tpu_torch.api import HFSpeechMixEED
    if args.hf_checkpoint_dir:
        spm = HFSpeechMixEED.from_reference_checkpoint(
            args.hf_checkpoint_dir, share_layer_ratio=args.share_layer_ratio,
            down_scale=args.down_scale, device=device)
    else:
        spm = HFSpeechMixEED(args.speech_model_config, args.nlp_model_config,
                             share_layer_ratio=args.share_layer_ratio,
                             down_scale=args.down_scale, device=device)
    if args.weights:
        spm.load_weights(args.weights)

    if args.librispeech_dir:
        from speechmix_tpu_torch.data.datasets import load_librispeech_dir
        from speechmix_tpu_torch.metrics import cer, wer
        from speechmix_tpu_torch.pipeline import TranscriptionPipeline
        examples = load_librispeech_dir(args.librispeech_dir)
        print(f"{len(examples)} utterances from {args.librispeech_dir}")
        gkw = {}
        if args.num_beam_groups > 1:
            gkw = {"num_beam_groups": args.num_beam_groups,
                   "diversity_penalty": args.diversity_penalty}
        pipe = TranscriptionPipeline(
            spm, batch_size=args.batch, max_length=args.max_length,
            num_beams=args.beam, kv_int8=args.kv_int8,
            min_length=args.min_length, generate_kwargs=gkw)
        hyps = pipe([ex["audio"] for ex in examples])
        refs = [ex["text"].lower() for ex in examples]
        print(json.dumps({"wer": wer(refs, hyps), "cer": cer(refs, hyps),
                          "n": len(refs)}))
        return

    if args.synthetic_eval:
        from speechmix_tpu_torch.data.collator import (BucketBatcher,
                                                       CollatorConfig)
        from speechmix_tpu_torch.data.datasets import (prepare_examples,
                                                       synthetic_corpus)
        from speechmix_tpu_torch.training.trainer import TrainConfig, Trainer
        raw = synthetic_corpus(args.synthetic_eval, seed=args.seed)
        examples = prepare_examples(raw, spm, use_teacher_targets=False,
                                    device=spm.device)
        ccfg = CollatorConfig(
            pad_token_id=spm.config.decoder.pad_token_id,
            bos_token_id=spm.tokenizer.bos_token_id,
            eos_token_id=spm.config.decoder.eos_token_id,
            max_label_length=spm.config.decoder.max_length,
            max_text_length=spm.config.decoder.max_length,
            align_samples=spm.config.encoder.aligned_samples)
        batcher = BucketBatcher(ccfg, args.batch)
        trainer = Trainer(spm.config, TrainConfig(output_dir=""),
                          tokenizer=spm.tokenizer, device=spm.device)
        m = trainer.predict(spm.params, lambda: batcher(examples),
                            max_length=args.max_length, num_beams=args.beam,
                            kv_int8=args.kv_int8)
        print(json.dumps(m))
        return

    if args.audio:
        from speechmix_tpu_torch.data import audio as audio_lib
        from speechmix_tpu_torch.data.datasets import _read_audio
        wav, sr = _read_audio(args.audio)
        wav = audio_lib.resample(audio_lib.to_mono(wav), sr)
    else:
        from speechmix_tpu_torch.data.datasets import synthetic_corpus
        ex = synthetic_corpus(1, seed=0)[0]
        wav = ex["audio"]
        print("reference text:", ex["text"])

    outputs = spm.generate([wav], decoder_text_prompt=args.prompt,
                           max_length=args.max_length,
                           max_new_tokens=args.max_new_tokens,
                           num_beams=args.beam,
                           kv_int8=args.kv_int8, min_length=args.min_length,
                           num_beam_groups=args.num_beam_groups,
                           diversity_penalty=args.diversity_penalty,
                           do_sample=args.do_sample,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, typical_p=args.typical_p,
                           encoder_no_repeat_ngram_size=(
                               args.encoder_no_repeat_ngram_size))
    decoded = spm.tokenizer.decode(np.asarray(outputs[0].cpu()),
                                   skip_special_tokens=True)
    print("decoded:", decoded)


if __name__ == "__main__":
    main()
