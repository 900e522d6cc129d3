"""train_images_per_s: the labeled and unlabeled images of every step in
the window over the time from its start to the last step's synchronised
end."""

from ..readers import rate


def read(rec):
    return rate(rec)
