"""Standalone probes run on the card to reproduce a finding; nothing in
the training path imports them."""
