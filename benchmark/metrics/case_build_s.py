"""case_build_s: the harness's timer around its calls into the app's
set-up modules, from the Params text to the state on the device."""


def read(rec, peaks):
    return rec["case_build_s"]
