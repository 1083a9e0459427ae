"""scp / segments parsing (copy of speech_recognition_tools_tpu/io/scp.py;
Kaldi conventions, as consumed by the reference CLIs
computeFDLPSpectrogram.py:125-154 and computeModulationSpectrum_segments.py)."""


def read_scp(path: str) -> list[tuple[str, str]]:
    """Read 'utt value...' lines. The value may be a path or a shell pipe
    ending in '|'."""
    entries = []
    with open(path) as f:
        for line in f:
            tokens = line.strip().split()
            if not tokens:
                continue
            entries.append((tokens[0], " ".join(tokens[1:])))
    return entries


def write_scp(entries, path: str):
    with open(path, "w") as f:
        for key, value in entries:
            f.write(f"{key} {value}\n")
    return path


def read_segments(path: str) -> list[tuple[str, str, float, float]]:
    """Kaldi segments: '<utt> <recording> <start_sec> <end_sec>'."""
    segs = []
    with open(path) as f:
        for line in f:
            tokens = line.strip().split()
            if not tokens:
                continue
            segs.append(
                (tokens[0], tokens[1], float(tokens[2]), float(tokens[3]))
            )
    return segs
