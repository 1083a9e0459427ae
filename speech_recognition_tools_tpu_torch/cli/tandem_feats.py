"""Tandem feature extraction: AM posteriors as features, and a PCA.

Port of speech_recognition_tools_tpu/cli/tandem_feats.py with its flags
(the reference's get_Tandem_feats.sh): run a train_am model over an egs
directory on the card (`--device cpu` for the CPU), take softmax
posteriors ('softmax') or pre-softmax activations ('presoftmax'), write
them as a feature ark/scp pair, and with `--get_pca` estimate a PCA
(utils/transforms.py, est-pca) and also write <out_base>_pca.{ark,scp} and
<out_base>_pca.pkl.

    python -m speech_recognition_tools_tpu_torch.cli.tandem_feats exp/am egs/ out/tandem \\
        [--tandem_type softmax] [--get_pca --pca_dim 40] [--device cpu]
"""

import argparse
import pickle


def get_parser():
    p = argparse.ArgumentParser("Tandem posterior features")
    p.add_argument("model_dir", help="train_am checkpoint dir")
    p.add_argument("egs_dir")
    p.add_argument("out_base", help="output ark/scp base name")
    p.add_argument("--tandem_type", choices=["softmax", "presoftmax"], default="presoftmax")
    p.add_argument("--get_pca", action="store_true",
                   help="estimate PCA on the posteriors (est-pca) and also write "
                        "<out_base>_pca.{ark,scp} + _pca.pkl")
    p.add_argument("--pca_dim", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)

    import numpy as np
    import torch

    from speech_recognition_tools_tpu_torch.cli.dump_outputs import (
        arch_forward,
        load_model_from_checkpoint,
    )
    from speech_recognition_tools_tpu_torch.device import resolve_device
    from speech_recognition_tools_tpu_torch.io.egs import iter_egs_batches
    from speech_recognition_tools_tpu_torch.io.kaldi_ark import write_ark_scp
    from speech_recognition_tools_tpu_torch.utils.transforms import apply_pca, estimate_pca

    dev = resolve_device(args.device)
    model, _, cfg = load_model_from_checkpoint(args.model_dir, dev)
    feats_out = {}
    with torch.no_grad():
        for b in iter_egs_batches(args.egs_dir, args.batch_size, drop_labels=True):
            lengths = torch.as_tensor(b["lengths"], device=dev)
            logits, _ = arch_forward(model, cfg, torch.as_tensor(b["feats"], device=dev),
                                     lengths,
                                     generator=torch.Generator().manual_seed(2))
            out = torch.softmax(logits, -1) if args.tandem_type == "softmax" else logits
            out = out.cpu().numpy()
            for i, k in enumerate(b["keys"]):
                feats_out[k] = out[i, : int(b["lengths"][i])]
    write_ark_scp(feats_out, args.out_base)
    print(f"wrote {len(feats_out)} tandem posterior mats -> {args.out_base}.ark")

    if args.get_pca:
        allf = np.concatenate(list(feats_out.values()), axis=0)
        transform, mean = estimate_pca(allf, dim=args.pca_dim)
        with open(args.out_base + "_pca.pkl", "wb") as f:
            pickle.dump({"transform": np.asarray(transform), "mean": np.asarray(mean)}, f)
        proj = {k: np.asarray(apply_pca(v, transform, mean)).astype(np.float32)
                for k, v in feats_out.items()}
        write_ark_scp(proj, args.out_base + "_pca")
        print(f"wrote PCA ({np.asarray(transform).shape}) features -> {args.out_base}_pca.ark")
    return feats_out


if __name__ == "__main__":
    main()
