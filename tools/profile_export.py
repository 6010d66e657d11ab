"""The flagship detector's exported program against its eager forward, on the card.

Builds ``graft_entry.flagship_entry()`` (Swin-L + FPN + CenterNet2 + the
Detic cascade + the mask head, bf16, B = 2, 896², seeded random weights),
exports it baked through ``divergen_tpu_torch.export``, loads the artifact
back, and for each of eager and exported prints the host-clock ms of a
forward (mean of 5 after 2) and a ``torch.profiler`` table of one forward:
the top operators by host time and by device time, the device total, and
the forward's slowest single operator calls on the host with their input
shapes and the calls that made them.

Usage (one H100): ``python3 tools/profile_export.py``
"""
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from divergen_tpu_torch import graft_entry  # noqa: E402
from divergen_tpu_torch.export import export_inference, load_exported, save_exported  # noqa: E402


def main() -> None:
    model, (images, sizes) = graft_entry.flagship_entry()
    sizes = sizes.to(torch.int32)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_exported(export_inference(model, model.state_dict(), batch=2, height=896,
                                              width=896, bake_params=True),
                             os.path.join(tmp, "flagship.pt2z"))
        art = load_exported(path)
    runs = {"eager": lambda: model(images, sizes), "exported": lambda: art(images, sizes)}
    with torch.no_grad():
        for name, fn in runs.items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            print(f"{name}: {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms a forward "
                  "(host clock, mean of 5)", flush=True)
        for name, fn in runs.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                fn()
                torch.cuda.synchronize()
            table = prof.key_averages()
            print(f"== {name}: by host time\n"
                  f"{table.table(sort_by='self_cpu_time_total', row_limit=25)}", flush=True)
            print(f"== {name}: by device time\n"
                  f"{table.table(sort_by='self_device_time_total', row_limit=15)}", flush=True)
            print(f"{name}: device total {sum(e.self_device_time_total for e in table) / 1e3:.3f} "
                  f"ms in {sum(e.count for e in table)} events", flush=True)
            ops = [e for e in prof.events() if e.name.startswith(("aten::", "divergen::"))]
            for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:15]:
                chain, parent = [], e.cpu_parent
                while parent is not None and len(chain) < 3:
                    chain.append(parent.name[:60])
                    parent = parent.cpu_parent
                print(f"{name}: slow call {e.name} {e.self_cpu_time_total:.1f} us self, shapes "
                      f"{e.input_shapes}, under {chain}", flush=True)


if __name__ == "__main__":
    main()
