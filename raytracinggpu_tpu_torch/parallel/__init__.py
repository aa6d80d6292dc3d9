"""Multi-device rendering (port of ``raytracinggpu_tpu/parallel``): the
(px, sp) sharded frame over ``torch.distributed`` (``sharding``) and the
multi-process demo with the multichip dry run (``multihost_demo``)."""
