// VideoResults.tsx: filterable list of all videos with fusion results,
// labeling, and annotation triggers.
import {api, h, main, pct, esc, short, when, table, toast, sevBadge, USER}
  from "/static/app.js";

export default async function VideoResults() {
  main.append(h(`<div class="panel"><h2>Videos</h2>
    <div class="row">
      <select id="fstatus"><option value="">all statuses</option>
        <option>completed</option><option>processing</option>
        <option>failed</option></select>
      <select id="flabel"><option value="">any label</option>
        <option value="1">lame</option><option value="0">sound</option></select>
      <button class="ghost" id="reload">Filter</button>
      <button class="ghost" id="export">Export JSON</button>
    </div><div id="list"></div></div>
    <div id="detail"></div>`));

  async function load() {
    const q = new URLSearchParams();
    const st = document.getElementById("fstatus").value;
    const lb = document.getElementById("flabel").value;
    if (st) q.set("status", st);
    if (lb) q.set("label", lb);
    q.set("limit", 200);
    const vids = (await api("/api/videos?" + q)).videos;
    // fetch fusion scores in parallel (best-effort)
    const fusions = await Promise.all(vids.map(v =>
      api(`/api/analysis/${v.id}/fusion`).catch(() => null)));
    vids.forEach((v, i) => {
      const fr = fusions[i] && fusions[i].fusion_result;
      v._p = fr ? fr.final_probability : null;
      v._mode = fr ? fr.decision_mode : null;
    });
    window._vrExport = vids;
    document.getElementById("list").innerHTML = vids.length ? table(vids, [
      ["id", v => `<span class="dim">${short(v.id, 12)}</span>`],
      ["file", v => esc(v.original_filename || v.filename || "")],
      ["status", v => `<span class="badge">${esc(v.status)}</span>`],
      ["fusion", v => v._p == null ? "—"
        : `${pct(v._p)} ${sevBadge(v._p)}`],
      ["mode", v => esc(v._mode || "—")],
      ["label", v => `${v.label == null ? "—" : v.label ? "lame" : "sound"}
        <button class="mini" data-l="1" data-v="${v.id}">lame</button>
        <button class="mini" data-l="0" data-v="${v.id}">sound</button>`],
      ["uploaded", v => `<span class="dim">${when(v.uploaded_at)}</span>`],
      ["", v => `<button class="mini" onclick="go('analysis','${v.id}')">
        analysis</button>`],
    ]) : `<span class="dim">no videos match</span>`;
    document.querySelectorAll("button[data-l]").forEach(b => {
      b.onclick = async (e) => {
        e.stopPropagation();
        try {
          await api(`/api/videos/${b.dataset.v}/label`,
                    {json: {label: +b.dataset.l}});
          toast("labeled"); load();
        } catch (err) { toast(err.message, "bad"); }
      };
    });
  }
  document.getElementById("reload").onclick = load;
  document.getElementById("export").onclick = () => {
    const blob = new Blob([JSON.stringify(window._vrExport, null, 2)],
                          {type: "application/json"});
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = "videos_export.json";
    a.click();
  };
  await load();
}
