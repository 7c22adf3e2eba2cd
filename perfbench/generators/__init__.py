"""Input generators, found by name: signature sets (a configuration's
``signatures.generator``) and corpora (a traffic mix's ``generator``)."""
