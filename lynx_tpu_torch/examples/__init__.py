"""The JAX package's examples (``examples/``), ported: PPO on the ARES-EA
environment, gradient tuning, the quad-scan emittance fit, image-based
tuning, the particle-fidelity sweep and a first tracking run.  Each runs as
``python -m lynx_tpu_torch.examples.<name>``, on the card unless given
``--device cpu``."""
