"""Traffic drivers, one per kind of traffic, found by the name a traffic file gives."""
