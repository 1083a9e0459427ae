"""Reference client of the serving daemon (cli/serve.py).

Port of speech_recognition_tools_tpu/cli/serve_client.py: streams a wav to
a running server in real-time-paced chunks (or back to back with
--no_pace), printing partials as they arrive and the final, with
per-token times and confidences, at the end:

    python -m speech_recognition_tools_tpu_torch.cli.serve_client utt.wav --port 8973
    ... --endpoint_blanks 20   # continuous mode

`stream_wav()` is the programmatic form.
"""

import argparse
import json
import socket


def get_parser():
    p = argparse.ArgumentParser("Stream a wav to a running srt-serve")
    p.add_argument("wav", help="input wav (any srate the server's frontend expects)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8973)
    p.add_argument("--chunk_s", type=float, default=0.25,
                   help="seconds of audio per pcm message")
    p.add_argument("--no_pace", action="store_true",
                   help="send chunks back to back instead of pacing them at "
                        "real time (benchmarking / smoke tests)")
    p.add_argument("--endpoint_blanks", type=int, default=0,
                   help="enable server-side endpointing (continuous "
                        "transcription; see cli/serve.py)")
    return p


def stream_wav(wav, host="127.0.0.1", port=8973, chunk_s=0.25, pace=True,
               endpoint_blanks=0, log=None):
    """Stream `wav` to the server; returns (final_msg, events), events being
    every server response in order (partials, endpoints, the final). `log`,
    when given, receives one display line per response as it arrives."""
    import time

    import numpy as np
    from scipy.io.wavfile import read as wav_read

    srate, sig = wav_read(wav)
    sig = np.asarray(sig, np.float32)
    if sig.ndim > 1:
        sig = sig[:, 0]
    step = max(1, int(chunk_s * srate))

    events = []
    s = socket.create_connection((host, port))
    try:
        f = s.makefile("rwb")

        def send(obj):
            f.write((json.dumps(obj) + "\n").encode())
            f.flush()

        def recv():
            line = f.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            msg = json.loads(line)
            events.append(msg)
            if "error" in msg:
                raise RuntimeError(f"server error: {msg['error']}")
            return msg

        if endpoint_blanks > 0:
            send({"config": {"endpoint_blanks": endpoint_blanks}})
            recv()  # {"ok": true}
        t0 = time.time()
        for off in range(0, len(sig), step):
            if pace:
                # a chunk covering [off, off + step) exists only once its
                # last sample was captured: never run ahead of real time
                end = min(off + step, len(sig))
                lag = (end / srate) - (time.time() - t0)
                if lag > 0:
                    time.sleep(lag)
            send({"pcm": sig[off : off + step].tolist()})
            msg = recv()
            if log is not None:
                if "endpoint" in msg:
                    log(f"[endpoint] {msg['endpoint']['final']}")
                elif msg.get("partial"):
                    log(f"[partial ] {msg['partial']}")
        send({"eof": True})
        final = recv()
        if log is not None:
            log(f"[final   ] {final.get('final', '')}")
        return final, events
    finally:
        s.close()


def main(argv=None):
    args = get_parser().parse_args(argv)
    final, events = stream_wav(
        args.wav, host=args.host, port=args.port, chunk_s=args.chunk_s,
        pace=not args.no_pace, endpoint_blanks=args.endpoint_blanks, log=print,
    )
    toks = final.get("tokens", [])
    for t, ts, c in zip(toks, final.get("times", []), final.get("confs", [])):
        print(f"  token {t:>5}  t={ts:7.3f}s  conf={c:.3f}")
    n_part = sum(1 for e in events if e.get("partial"))
    print(f"({len(toks)} tokens, {n_part} partial updates, "
          f"{final.get('frames', 0)} encoder frames)")


if __name__ == "__main__":
    main()
