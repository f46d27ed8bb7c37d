"""RS(10,4) erasure coding of volumes: encode, rebuild, degraded reads, decode."""
