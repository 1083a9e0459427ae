"""MFCC CLI: the flags of speech_recognition_tools_tpu/cli/compute_mfcc.py
(reference computeMfccFeatures.py :138-150), running the port on the card.

    python -m speech_recognition_tools_tpu_torch.cli.compute_mfcc \\
        wav.scp out/feats [--nfilters 30 --context 4 ...] [--device cpu]

--add_noise 'type,snr' | diff and --add_reverb augment on the host as the
JAX CLI does; --data_parallel raises NotImplementedError naming its
ROADMAP item; --kaldi_cmd is accepted and ignored (arks are written
natively), as in the JAX CLI.
"""

import argparse
import time


def get_parser():
    parser = argparse.ArgumentParser("Extract MFCC Features")
    parser.add_argument("scp")
    parser.add_argument("outfile")
    parser.add_argument("--nfilters", type=int, default=30)
    parser.add_argument("--fduration", type=float, default=0.02)
    parser.add_argument("--frate", type=int, default=100)
    parser.add_argument("--context", type=int)
    parser.add_argument("--nfft", type=int, default=1024)
    parser.add_argument("--add_reverb", help="clean|small_room|medium_room|large_room")
    parser.add_argument("--add_noise", default="none", help="'type,snr' | none | clean | diff")
    parser.add_argument("--kaldi_cmd", help="ignored: arks written natively")
    parser.add_argument("--srate", type=int, default=16000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--data_parallel", action="store_true", help="not yet ported")
    parser.add_argument("--write_utt2num_frames", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    from speech_recognition_tools_tpu_torch.cli.common import add_profiling_arg

    add_profiling_arg(parser)
    return parser


def main(argv=None):
    from speech_recognition_tools_tpu_torch.cli.common import (
        check_unported,
        finish,
        load_signals,
        profiled_extraction,
        run_batched,
    )

    args = get_parser().parse_args(argv)
    check_unported(args)
    start = time.time()

    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.dsp.mfcc import MfccConfig, mfcc_batch

    device = resolve_device(args.device)
    cfg = MfccConfig(srate=args.srate, nfilters=args.nfilters, fduration=args.fduration,
                     frate=args.frate, nfft=args.nfft, context=args.context)
    signals = load_signals(args, args.srate)
    ctx, meter = profiled_extraction(args, device)
    with ctx:
        feats = run_batched(signals, lambda b, n: mfcc_batch(b, n, cfg, device=device),
                            batch_size=args.batch_size, meter=meter, srate=args.srate)
    finish(args, feats, meter=meter)
    print(f"Execution Time: {time.time() - start:.3f} seconds")


if __name__ == "__main__":
    main()
