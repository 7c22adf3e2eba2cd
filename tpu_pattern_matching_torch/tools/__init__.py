"""Tools of the port: counterparts of the reference's ``tools/`` scripts
(``fuzz_campaign``, the randomized differential campaign;
``length_trains``, the tshark-trace to packet-length-train extractor)."""
