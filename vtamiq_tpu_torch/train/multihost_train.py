"""Multi-process training through ``engine.train()`` on a mesh of ranks.

Counterpart of the JAX package's ``examples/multihost_train.py``. Run one
process per card, under torchrun:

    torchrun --nproc-per-node 4 -m vtamiq_tpu_torch.train.multihost_train
        [--data 2 --model 2 --seq 1] [--epochs 20] [--batch-size 16]

or by hand, one command per rank (i = 0, 1):

    python -m vtamiq_tpu_torch.train.multihost_train --coordinator host0:29500
        --num-processes 2 --process-id i

Each rank runs on ``cuda:<local rank>`` over NCCL unless ``--device`` /
``--backend`` say otherwise (``--backend gloo`` lets ranks share a card).
The mesh defaults to data parallelism over every rank; ``--batch-size`` is
the batch of one data rank (global = batch x data). The test correlations
are the same on every rank (predictions are all-gathered); rank 0 prints
them and writes every file.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None, help="this rank's device (default cuda:<local rank>)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--data", type=int, default=1, help="mesh_data (1 with model = seq = 1: "
                    "every rank)")
    ap.add_argument("--model", type=int, default=1, help="mesh_model (tensor parallel)")
    ap.add_argument("--seq", type=int, default=1, help="mesh_seq (ring attention)")
    ap.add_argument("--dataset", default=None, help="dataset name (default TID2013)")
    ap.add_argument("--vit-npz", default=None)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16,
                    help="batch of one data rank; global = this x data")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..parallel import distributed as D
    index, count = D.initialize(coordinator_address=args.coordinator,
                                num_processes=args.num_processes,
                                process_id=args.process_id,
                                local_device=args.device, backend=args.backend)
    try:
        from . import config as C, engine
        g = C.global_config
        g.update(dataset=args.dataset or C.DATASET_TID2013, do_train=True, do_val=True,
                 do_test=True, num_epochs=args.epochs, seed=args.seed,
                 vit_weights_path=args.vit_npz, device=str(D.rank_device()),
                 mesh_data=args.data, mesh_model=args.model, mesh_seq=args.seq)
        # honour the batch size: without this flag validate_configs overwrites
        # batch and patch counts from the per-dataset defaults
        C.dataloader_config_base[C.DATALOADER_PARAMS][C.USE_DEFAULT_PARAMS] = True
        for split in (C.SPLIT_NAME_TRAIN, C.SPLIT_NAME_VAL, C.SPLIT_NAME_TEST):
            C.dataloader_config_base[split][C.BATCH_SIZE] = args.batch_size
        correlations = engine.train()
        if D.is_coordinator():
            print(f"process {index}/{count}: test correlations {correlations}", flush=True)
        return correlations
    finally:
        D.shutdown()


if __name__ == "__main__":
    main()
