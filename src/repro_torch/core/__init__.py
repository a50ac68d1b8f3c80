"""SpaceVerse core of the port (inference): the EO adapter, Eq. (2) region
scoring, the Eq. (3) multi-scale filter, the progressive confidence net,
the latency model and the cascade's configuration records."""
