"""Which of gloo's collectives take CUDA tensors, on this machine's torch.

    python3 tools/torch_gloo_probe.py

For each collective, two ranks (processes of this script) on cuda:0 join a
gloo group through a ``file://`` store and run it once on CUDA tensors;
a collective that raises, kills a rank or hangs (60 s) shows in its exit
codes and last output line. Prints one line per collective and, last, one
JSON object of all of them. ``vtamiq_tpu_torch/parallel/comm.py`` stages
through host memory what fails here.
"""

import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "batch_isend_irecv", "reduce_scatter_tensor")


def rank_main(op: str, rank: int, store: str):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    torch.cuda.set_device(0)
    x = torch.full((4,), float(rank + 1), device="cuda")
    if op == "all_reduce":
        dist.all_reduce(x)
        out = x
    elif op == "broadcast":
        dist.broadcast(x, 0)
        out = x
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        out = torch.cat(parts)
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(out, x)
    elif op == "batch_isend_irecv":
        out = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                           dist.P2POp(dist.irecv, out, 1 - rank)]):
            req.wait()
    else:
        out = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(out, x)
    torch.cuda.synchronize()
    print("RESULT", rank, out.tolist(), flush=True)
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    results = {}
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), op, str(r),
                                       store], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for r in range(2)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=60)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append("TIMEOUT " + (p.communicate()[0] or ""))
        results[op] = {"exit_codes": [p.returncode for p in procs],
                       "last_lines": [o.strip().splitlines()[-1][:240] if o.strip() else ""
                                      for o in outs]}
        print(op, json.dumps(results[op]), flush=True)
    print(json.dumps({"torch": torch.__version__, "gloo_cuda_collectives": results}))


if __name__ == "__main__":
    if len(sys.argv) == 4:
        rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    else:
        main()
