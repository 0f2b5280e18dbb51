"""The port's ``tfpark``: the text estimators (``tfpark.text``)."""
