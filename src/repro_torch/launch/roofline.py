"""Chip constants of the analytic cost model.

These are the modelled-cluster numbers the placement cost model prices
plans with (``core/costmodel.py``'s ``Resource`` defaults and the
``CLOUD_POD`` preset). They are kept numerically identical to the JAX
package's so that both packages choose the same plans on the same
inputs. They describe the modelled cloud accelerator of the cost model,
not a measurement of the card the port runs on.
"""

from __future__ import annotations

PEAK_FLOPS = 197e12        # modelled flop/s per chip
HBM_BW = 819e9             # modelled memory bytes/s per chip
LINK_BW = 50e9             # modelled link bytes/s per link
