"""FDLP spectrogram CLI: the flags of
speech_recognition_tools_tpu/cli/compute_fdlp_spectrogram.py (reference
computeFDLPSpectrogram.py :240-262), running the port on the card.

    python -m speech_recognition_tools_tpu_torch.cli.compute_fdlp_spectrogram \
        wav.scp out/feats [--nfilters 80 --order 150 ...] [--device cpu]

--profile_dir traces the extraction with torch.profiler; --precision high
(alias mixed) computes in float64 from the window multiply on.
--add_noise 'type,snr' | diff and --add_reverb augment each utterance on
the host as the JAX CLI does (cli/common.py::augment). --data_parallel
raises NotImplementedError naming its ROADMAP item.
"""

import argparse
import sys
import time


def get_parser():
    parser = argparse.ArgumentParser("Extract FDLP Spectrogram.")
    parser.add_argument("scp", help='"scp" list')
    parser.add_argument("outfile", help="output file")
    parser.add_argument("--scp_type", default="wav", help="'wav' or 'segment'")
    parser.add_argument("--wav_scp", help="recording wav scp for --scp_type segment")
    parser.add_argument("--nfilters", type=int, default=20)
    parser.add_argument("--coeff_num", type=int, default=50)
    parser.add_argument("--coeff_range", type=str, default="1,20")
    parser.add_argument("--order", type=int, default=50)
    parser.add_argument("--fduration", type=float, default=0.5)
    parser.add_argument("--frate", type=int, default=100)
    parser.add_argument("--overlap_fraction", type=float, default=0.25)
    parser.add_argument("--kaldi_cmd", default="copy-feats",
                        help="ignored: arks are written natively")
    parser.add_argument("--add_reverb", help="clean|small_room|medium_room|large_room")
    parser.add_argument("--fbank_type", type=str, default="mel,1")
    parser.add_argument("--odd_mod_zero", action="store_true")
    parser.add_argument("--gamma_weight", type=str, default="None")
    parser.add_argument("--lifter_config", type=str, default=None)
    parser.add_argument("--write_utt2num_frames", action="store_true")
    parser.add_argument("--add_noise", help="'type,snr' | clean | diff")
    parser.add_argument("--srate", type=int, default=16000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--bucket_seconds", type=float, default=1.0,
                        help="round the padded batch length up to this many "
                             "seconds")
    parser.add_argument("--data_parallel", action="store_true",
                        help="not yet ported")
    parser.add_argument("--precision", default="fast",
                        choices=["fast", "mixed", "high"],
                        help="'fast' (float32) or 'high' (float64 from the "
                             "window multiply on; 'mixed' is an alias)")
    parser.add_argument("--random_jitter", action="store_true",
                        help="enable the reference's +-1 frame OLA jitter "
                             "(drawn from a torch.Generator seeded 0, so "
                             "its bits differ from the JAX CLI's)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
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
    print(f"{sys.argv[0]}: Extracting features....")

    import torch
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.dsp.fdlp import (
        FdlpConfig,
        fdlp_spectrogram_batch,
    )
    from speech_recognition_tools_tpu_torch.ops.framing import (
        frame_count,
        frame_params,
    )

    device = resolve_device(args.device)
    lifter = None
    if args.lifter_config:
        with open(args.lifter_config) as fid:
            lifter = tuple(float(x) for x in fid.readline().strip().split(","))
    cfg = FdlpConfig(
        srate=args.srate, nfilters=args.nfilters, coeff_num=args.coeff_num,
        coeff_range=args.coeff_range, order=args.order,
        fduration=args.fduration, frate=args.frate,
        overlap_fraction=args.overlap_fraction, fbank_type=args.fbank_type,
        odd_mod_zero=args.odd_mod_zero, gamma_weight=args.gamma_weight,
        lifter_config=lifter, precision=args.precision,
    )
    signals = load_signals(args, args.srate)
    gen = torch.Generator().manual_seed(0) if args.random_jitter else None
    fp = frame_params(cfg.srate, cfg.lfr, cfg.fduration)

    def batch_fn(batch, lens):
        jitter = None
        if gen is not None:
            F = frame_count(batch.shape[1], fp)
            jitter = torch.randint(0, 2, (batch.shape[0], F), generator=gen)
        return fdlp_spectrogram_batch(batch, lens, cfg, jitter=jitter,
                                      device=device)

    ctx, meter = profiled_extraction(args, device)
    with ctx:
        feats = run_batched(signals, batch_fn, batch_size=args.batch_size,
                            bucket_multiple=int(args.bucket_seconds * args.srate),
                            meter=meter, srate=args.srate)
    finish(args, feats, meter=meter)
    print(f"Execution Time: {time.time() - start:.3f} seconds")


if __name__ == "__main__":
    main()
