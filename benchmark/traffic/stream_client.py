#!/usr/bin/env python3
"""The live-stream clients of traffic kind "stream", in a process of their
own (numpy and the standard library only), so that client work does not
share the server's interpreter.

    python3 benchmark/traffic/stream_client.py < plan.json

It reads one line of JSON from standard input: {"port", "signals" (an
.npz of int16-scale utterances named s<stream>_u<utt>), "streams",
"chunk_s", "srate", "offsets" (each stream's start from t0, s; before
the window where negative),
"seconds" (the window), "drain_s"}, prints "ready", then reads a second
line {"t0": wall-clock start}. Every stream sends its utterances back to
back, one connection each, in an open loop: message k of an utterance
that starts at t_u is due at t_u + k chunk_s whether or not earlier
replies came; eof is due when the audio ends, and so is the next
utterance. No utterance starts after the window's end. Each utterance
prints one JSON line: the due, sent and reply times of its messages (a
reply that never came is null), its partials and its final.
"""

import asyncio
import json
import sys
import time

import numpy as np


async def _utterance(port, sig, t_u, chunk, srate, deadline):
    """Send one utterance; returns its record."""
    n_msgs = max(1, -(-len(sig) // chunk))
    due = [t_u + k * chunk / srate for k in range(n_msgs)]
    eof_due = t_u + len(sig) / srate
    rec = {"due": due, "sent": [None] * n_msgs, "arrival": [None] * n_msgs,
           "partials": [None] * n_msgs, "eof_due": eof_due, "final": None,
           "final_arrival": None, "error": None}
    await asyncio.sleep(max(0.0, t_u - time.time()))
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    except OSError as e:
        rec["error"] = f"connect: {e}"
        return rec

    async def read_replies():
        for k in range(n_msgs + 1):
            line = await reader.readline()
            if not line:
                return
            now = time.time()
            msg = json.loads(line)
            if k < n_msgs:
                rec["arrival"][k] = now
                rec["partials"][k] = msg.get("partial")
                if "error" in msg:
                    rec["error"] = msg["error"]
                    return
            else:
                rec["final_arrival"] = now
                rec["final"] = msg

    replies = asyncio.ensure_future(read_replies())
    try:
        for k in range(n_msgs):
            await asyncio.sleep(max(0.0, due[k] - time.time()))
            pcm = sig[k * chunk:(k + 1) * chunk].astype(np.int64).tolist()
            writer.write((json.dumps({"pcm": pcm}) + "\n").encode())
            await writer.drain()
            rec["sent"][k] = time.time()
        await asyncio.sleep(max(0.0, eof_due - time.time()))
        writer.write(b'{"eof": true}\n')
        await writer.drain()
        await asyncio.wait_for(replies, timeout=max(1.0, deadline - time.time()))
    except (OSError, asyncio.TimeoutError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        replies.cancel()
    finally:
        writer.close()
    return rec


async def _stream(i, plan, sigs, t0, out):
    t_u = t0 + plan["offsets"][i]
    end = t0 + plan["seconds"]
    deadline = end + plan["drain_s"]
    chunk = int(round(plan["chunk_s"] * plan["srate"]))
    j = 0
    pending = []
    while t_u < end:
        sig = sigs[i][j % len(sigs[i])]
        task = asyncio.ensure_future(_utterance(plan["port"], sig, t_u, chunk, plan["srate"],
                                                deadline))
        pending.append((j, task))
        t_u += len(sig) / plan["srate"]
        j += 1
    for j, task in pending:
        rec = await task
        rec.update(stream=i, utt=j % len(sigs[i]), seq=j)
        out.append(rec)


async def _main(plan, sigs, t0):
    out = []
    await asyncio.gather(*(_stream(i, plan, sigs, t0, out) for i in range(plan["streams"])))
    return out


def main():
    plan = json.loads(sys.stdin.readline())
    blob = np.load(plan["signals"])
    sigs = [[blob[f"s{i}_u{j}"] for j in range(plan["utterances"])]
            for i in range(plan["streams"])]
    print("ready", flush=True)
    t0 = json.loads(sys.stdin.readline())["t0"]
    for rec in asyncio.run(_main(plan, sigs, t0)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
