# graphlint fixture: deliberately unparsable (LNT000); never imported.
def f(:
