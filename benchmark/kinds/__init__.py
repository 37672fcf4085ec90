"""Traffic kinds: `kinds/<kind>.py` drives the cells whose traffic mix
names that kind (harness.py loads it by name)."""
