"""Multi-device and multi-process parallelism: pair-block-sharded matching
over a device list (`matching`) and the multi-process driver on
torch.distributed (`distributed`: initialization, host-sharded features and
matches, run_ba_multihost, run_sfm_multihost). Sharded bundle adjustment
lives in sfm_danpipeline_torch.ba.sharded."""
