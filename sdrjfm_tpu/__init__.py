"""sdrjfm_tpu — an accelerator-native broadcast-FM receive framework.

A from-scratch JAX/XLA re-design of the capabilities of the sdr-j-fm
receiver (reference: /root/reference, JvanKatwijk/sdr-j-fm): 2.304 MS/s IQ
front end, decimation cascade, FM discrimination, 19 kHz pilot stereo with
perfect-stereo-separation correction, deemphasis, squelch, band scan, and the
57 kHz RDS BPSK stack (bit recovery on the device, block sync / Meggitt FEC / group
decode on host).

Instead of the reference's per-sample C++ loop, sample streams are processed
as batched time blocks with an explicit carry pytree; recursive loop state is
computed with associative scans or sub-block scans, and multi-chip operation
shards time blocks over a jax.sharding.Mesh with overlap halos and carry
exchange via collectives.
"""

from . import constants

__version__ = "0.1.0"
