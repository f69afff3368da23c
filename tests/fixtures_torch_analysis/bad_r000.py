"""R000 fixture: the file must not even parse."""
def broken(:
    pass
