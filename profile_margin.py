"""Whether ``torch.profiler`` keeps every device record of a short session,
on one GPU.

    python3 profile_margin.py

from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It serves the card tests' tiny two-layer model (``_tiny_served`` of
``tests/test_torch_gpu_kernels.py``) with speculation and the one-layer
self-draft, bf16, per-op and mega, then profiles one replay of each
captured program (the verify step, the draft catch-up step, each draft
chain) ``N`` times in each of three forms: the replay, a synchronize and
0.2 s of idle host time before the profiler stops ("tail"); the same with
0.2 s of idle host time after it starts too ("head+tail"); three replays
with the tail ("3 replays"). Prints, per program and form, how many
sessions held no device event and the device-event counts seen (a replay
holds a fixed number), then one JSON line.
"""
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path[0:1] = [str(ROOT), str(ROOT / "tests")]
import test_torch_gpu_kernels as t  # noqa: E402
from paddle_tpu_torch.inference import ServingPredictor  # noqa: E402

N = 15
MARGIN_S = 0.2


def session(run, head, reps):
    """Device events in one profiled session of ``reps`` calls of ``run``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if head:
            time.sleep(MARGIN_S)
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    return sum(ev.device_type() == DeviceType.CUDA
               for ev in prof.profiler.kineto_results.events())


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_margin: needs a CUDA device", file=sys.stderr)
        return 2
    cuda = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for form in ("per-op", "mega"):
        model, prompts = t._tiny_served(cuda)
        sp = ServingPredictor(model, spec_decode_k=4, draft_source="model",
                              draft_layers=1, max_batch=3, page_size=8,
                              chunk=8, device=cuda, dtype=torch.bfloat16,
                              mega_decode=form == "mega")
        sp.generate(prompts, 12)
        torch.cuda.synchronize()
        eng = sp._draft_engine
        progs = [("verify", sp._unified), ("catchup", eng._catchup)] + [
            (f"chain{k}", c) for k, c in sorted(eng._chains.items())]
        for name, owner in progs:
            for p in owner._programs.values():
                for variant, head, reps in (("tail", False, 1),
                                            ("head+tail", True, 1),
                                            ("3 replays", False, 3)):
                    counts = [session(lambda: owner(*p.args), head, reps)
                              for _ in range(N)]
                    key = f"{form} {name} {variant}"
                    out[key] = dict(empty=sum(c == 0 for c in counts),
                                    counts=sorted(set(counts)))
                    print(key, out[key], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
