"""The round-replay simulator's spec section (the simulator itself comes
with ROADMAP.md Queue 1 item 11)."""
