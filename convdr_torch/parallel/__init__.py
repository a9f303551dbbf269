"""Multi-GPU over ``torch.distributed``: process groups and meshes
(:mod:`~convdr_torch.parallel.mesh`), row-sharded search
(:mod:`~convdr_torch.parallel.sharded_search`) and the multi-rank dry run
(:mod:`~convdr_torch.parallel.dryrun`). The retrieval modules import the
mesh helpers, so this package imports none of its modules itself."""
