"""FDLP modulation-spectrum (M-vector) CLI: the flags of
speech_recognition_tools_tpu/cli/compute_modulation_spectrum.py
(reference computeModulationSpectrum.py :208-229), running the port on the
card.

    python -m speech_recognition_tools_tpu_torch.cli.compute_modulation_spectrum \\
        wav.scp out/feats [--set_unity_gain --complex_modulation ...] \\
        [--scp_type segment --wav_scp wav.scp] [--device cpu]

--profile_dir traces the extraction with torch.profiler. --add_reverb
convolves each utterance with the room's RIR on the host, as the JAX CLI
does; --data_parallel raises NotImplementedError naming its ROADMAP item.
"""

import argparse
import time


def get_parser():
    parser = argparse.ArgumentParser("Extract FDLP Modulation Spectral Features.")
    parser.add_argument("scp")
    parser.add_argument("outfile")
    parser.add_argument("--scp_type", default="wav")
    parser.add_argument("--wav_scp", help="recording wav scp for --scp_type segment")
    parser.add_argument("--nfilters", type=int, default=15)
    parser.add_argument("--coeff_0", type=int, default=5)
    parser.add_argument("--coeff_n", type=int, default=30)
    parser.add_argument("--keep_even", action="store_true")
    parser.add_argument("--order", type=int, default=50)
    parser.add_argument("--fduration", type=float, default=0.5)
    parser.add_argument("--frate", type=int, default=100)
    parser.add_argument("--add_reverb", help="clean|small_room|medium_room|large_room")
    parser.add_argument("--fbank_type", type=str, default="mel,1")
    parser.add_argument("--set_unity_gain", action="store_true")
    parser.add_argument("--no_window", action="store_true")
    parser.add_argument("--complex_modulation", action="store_true")
    parser.add_argument("--compensate_noise", action="store_true")
    parser.add_argument("--absolute_value", action="store_true")
    parser.add_argument("--kaldi_cmd", help="ignored: arks are written natively")
    parser.add_argument("--srate", type=int, default=16000)
    parser.add_argument("--batch_size", type=int, default=8)
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
    from speech_recognition_tools_tpu_torch.dsp.modspec import (
        ModSpecConfig,
        modulation_spectrum_batch,
    )

    device = resolve_device(args.device)
    cfg = ModSpecConfig(
        srate=args.srate, nfilters=args.nfilters, coeff_0=args.coeff_0,
        coeff_n=args.coeff_n, order=args.order, fduration=args.fduration,
        frate=args.frate, fbank_type=args.fbank_type, keep_even=args.keep_even,
        complex_modulation=args.complex_modulation,
        compensate_noise=args.compensate_noise, absolute_value=args.absolute_value,
        set_unity_gain=args.set_unity_gain, no_window=args.no_window,
    )
    signals = load_signals(args, args.srate)
    ctx, meter = profiled_extraction(args, device)
    with ctx:
        feats = run_batched(signals,
                            lambda b, n: modulation_spectrum_batch(b, n, cfg, device=device),
                            batch_size=args.batch_size, meter=meter, srate=args.srate)
    finish(args, feats, meter=meter)
    print(f"Execution Time: {time.time() - start:.3f} seconds")


if __name__ == "__main__":
    main()
