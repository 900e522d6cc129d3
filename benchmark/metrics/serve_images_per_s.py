"""serve_images_per_s: the images of every request completed in the window
over the time from its start to the last request's synchronised end."""

from ..readers import rate


def read(rec):
    return rate(rec)
