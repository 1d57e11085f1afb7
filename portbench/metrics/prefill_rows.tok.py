"""prefill_rows.tok: prompts an admission wave prefills, from the
service's counters over the window: rows admitted (`prefills`) over
waves (decode `steps`: one a wave when every request asks for one
token)."""


def read(ctx):
    if not ctx.get("waves"):
        return None
    return ctx["rows"] / ctx["waves"]
