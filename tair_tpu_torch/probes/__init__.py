"""Probes of the card: small hand-written kernels that measure what a kernel
design would rest on (a gather's rate, the streaming rate, the stages of the
msda corner reduce), each beside its plain version and runnable alone with
``python3 -m tair_tpu_torch.probes.<name>``."""
