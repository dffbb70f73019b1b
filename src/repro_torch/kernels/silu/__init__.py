"""SiLU with the reference's rounding points: plain version and wrapper."""
