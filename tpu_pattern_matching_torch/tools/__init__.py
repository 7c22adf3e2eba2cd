"""Tools of the port: counterparts of the reference's ``tools/`` scripts
(``fuzz_campaign``, the randomized differential campaign)."""
