// CowDetail.tsx (636 LoC): per-cow drill-down — aggregated prediction
// gauge, trend indicator over a selectable day range, stat tiles, latest
// LLM explanation, three tabs (timeline with hover bar chart + record
// table incl. per-pipeline scores, video history, technical details),
// registry edit (tag + notes).
import {api, h, main, pct, fmt, esc, short, when, gauge, toast, sevBadge,
        USER} from "/static/app.js";

const TREND = {improving: ["📉", "Improving", "var(--ok)"],
               worsening: ["📈", "Worsening", "var(--bad)"],
               stable: ["➡", "Stable", "var(--warn)"],
               unknown: ["?", "Unknown", "var(--dim)"],
               insufficient_data: ["…", "Not enough data", "var(--dim)"]};
const scoreColor = (v) => v < 0.3 ? "var(--ok)" : v < 0.5 ? "#d4a017"
  : v < 0.7 ? "#e8833a" : "var(--bad)";

export default async function CowDetail(cowId, daysArg) {
  if (!cowId) return go("cows");
  const days = +daysArg || 30;
  const cow = await api(`/api/cows/${cowId}`);
  const [hist, vids] = await Promise.all([
    api(`/api/cows/${cowId}/lameness-history?days=${days}`),
    api(`/api/cows/${cowId}/videos`)
      .then(r => r.videos || []).catch(() => [])]);
  let pred = null;
  try { pred = (await api(`/api/cows/${cowId}/prediction`)).prediction; }
  catch (e) {}
  const timeline = hist.timeline || [];
  const [tIcon, tText, tColor] = TREND[hist.trend]
    || TREND.unknown;
  const privileged = USER && ["admin", "researcher"].includes(USER.role);

  main.append(h(`<div class="panel"><h2>🐮 ${esc(short(cowId, 18))}
      <button class="mini" onclick="go('cows')">back</button>
      ${privileged ? `<button class="mini" id="cd-edit">edit</button>` : ""}
      </h2>
    <div class="grid" style="grid-template-columns:repeat(3,1fr)">
      <div class="panel" style="text-align:center">${pred
        ? `${gauge(pred.aggregated_score, "aggregated")}
          <div>${sevBadge(pred.aggregated_score)}
            <span class="badge">${esc(pred.severity_level)}</span></div>`
        : `<div class="dim" style="padding:20px">no prediction yet</div>`}
      </div>
      <div class="panel" style="text-align:center">
        <div class="dim">trend (${hist.days_range ?? days}d)
          <select id="cd-days" style="font-size:11px">
            ${[7, 30, 90, 365].map(d => `<option value="${d}"
              ${d === days ? "selected" : ""}>${d}d</option>`).join("")}
          </select></div>
        <div style="font-size:22px;color:${tColor};margin-top:8px">${tIcon}
          ${tText}</div>
        <div class="dim" style="font-size:11px">${hist.total_records ?? 0}
          records in range</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${vids.length}</div>
        <div class="dim">videos · ${cow.total_sightings} sightings</div>
        <div class="dim" style="font-size:11px">confidence
          ${pred ? pct(pred.confidence) : "—"}</div></div></div>
    <div class="row" style="margin-top:6px;font-size:12px;flex-wrap:wrap">
      <span class="dim">first seen <b>${when(cow.first_seen)}</b></span>
      <span class="dim">last seen <b>${when(cow.last_seen)}</b></span>
      <span class="dim">tag <b>${esc(cow.tag_number || "—")}</b></span>
      <span class="dim">embeddings <b>${esc(cow.embedding_version || "—")}
        </b></span></div>
    <div id="cd-editrow"></div>
    <div class="row" id="cd-tabs" style="margin-top:10px">
      <button class="mini" data-t="timeline">📊 timeline</button>
      <button class="mini" data-t="videos">📹 videos</button>
      <button class="mini" data-t="details">🔧 details</button></div>
    <div id="cd-content" style="margin-top:8px"></div></div>
  <div class="panel"><h2>🤖 Latest AI analysis
      <span class="dim">from the most recent video</span></h2>
    <div id="cd-llm" class="dim">no analyzed videos yet</div></div>`));

  // latest LLM explanation (tsx:334-344)
  const latestVid = timeline[0]?.video_id || vids[0]?.video_id;
  if (latestVid) {
    api(`/api/analysis/${latestVid}/explanation/get`)
      .then(ex => document.getElementById("cd-llm").textContent =
        ex.explanation || JSON.stringify(ex))
      .catch(() => {});
  }

  const tabs = document.getElementById("cd-tabs");
  const content = document.getElementById("cd-content");
  let active = "timeline";

  const renderTimeline = () => {
    if (!timeline.length) {
      content.innerHTML = `<span class="dim">no lameness records in the
        last ${days} days</span>`;
      return;
    }
    const bars = timeline.slice().reverse();   // oldest → newest
    content.innerHTML = `<div class="row" style="align-items:flex-end;
        height:110px;gap:2px">
      ${bars.map(e => {
        const s = e.fusion_score ?? 0.5;
        return `<div style="flex:1;min-width:6px;background:${
          scoreColor(s)};height:${Math.max(5, 100 * s)}%;
          border-radius:2px 2px 0 0${e.human_validated
            ? ";outline:2px solid var(--accent)" : ""}"
          title="${when(e.observation_date)}: ${pct(s)}${
            e.human_validated ? " ✓ validated" : ""}"></div>`;
      }).join("")}</div>
      <div class="dim" style="font-size:11px;margin:2px 0 8px">oldest →
        newest · outline = human-validated</div>
      <table><tr><th>date</th><th>video</th><th>fusion</th><th>severity</th>
        <th>pipelines</th><th>validated</th><th></th></tr>
      ${timeline.map(e => {
        const ps = e.pipeline_scores || {
          tleap: e.tleap_score, tcn: e.tcn_score,
          transformer: e.transformer_score, gnn: e.gnn_score,
          graph_transformer: e.graph_transformer_score,
          ml_ensemble: e.ml_ensemble_score};
        return `<tr>
        <td class="dim">${when(e.observation_date)}</td>
        <td class="dim">${short(e.video_id, 10)}</td>
        <td><div class="row"><div class="bar" style="width:64px">
          <i style="width:${100 * (e.fusion_score ?? 0)}%;background:${
            scoreColor(e.fusion_score ?? 0)}"></i></div>
          <span style="font-size:11px">${pct(e.fusion_score)}</span></div>
        </td>
        <td>${sevBadge(e.fusion_score)}</td>
        <td class="dim" style="font-size:11px">${Object.entries(ps)
          .filter(([, v]) => v != null).map(([k, v]) =>
            `${k}:${fmt(v, 2)}`).join(" ")}</td>
        <td>${e.human_validated ? "✓" : "—"}</td>
        <td><button class="mini" onclick="go('analysis','${e.video_id}')">
          analysis</button></td></tr>`;
      }).join("")}</table>`;
  };

  const renderVideos = () => {
    content.innerHTML = vids.length ? `<table>
      <tr><th>video</th><th>track</th><th>frames</th><th>re-id conf</th>
        <th>seen</th><th></th></tr>
      ${vids.map(v => `<tr>
        <td class="dim">${short(v.video_id || v.id, 14)}</td>
        <td>${v.track_id ?? "—"}</td>
        <td class="dim">${v.total_frames ?? "—"}</td>
        <td>${v.reid_confidence != null ? pct(v.reid_confidence) : "—"}</td>
        <td class="dim">${when(v.created_at || v.first_seen_at)}</td>
        <td><button class="mini"
          onclick="go('analysis','${v.video_id || v.id}')">analysis
          </button></td></tr>`).join("")}</table>`
      : `<span class="dim">no linked videos</span>`;
  };

  const renderDetails = () => {
    content.innerHTML = `<div class="kv">
      <span class="dim">registry id</span><b>${esc(cow.id)}</b>
      <span class="dim">cow id</span><b>${esc(cow.cow_id)}</b>
      <span class="dim">tag number</span><b>${esc(cow.tag_number || "—")}
      </b>
      <span class="dim">embedding version</span>
        <b>${esc(cow.embedding_version || "—")}</b>
      <span class="dim">total sightings</span><b>${cow.total_sightings}</b>
      <span class="dim">active</span><b>${cow.is_active ? "yes" : "no"}</b>
      <span class="dim">notes</span><b>${esc(cow.notes || "—")}</b></div>`;
  };

  const render = () => {
    [...tabs.children].forEach(b =>
      b.style.outline = b.dataset.t === active ? "2px solid var(--accent)"
        : "");
    ({timeline: renderTimeline, videos: renderVideos,
      details: renderDetails})[active]();
  };
  [...tabs.children].forEach(b => b.onclick = () => {
    active = b.dataset.t; render();
  });
  render();

  document.getElementById("cd-days").onchange = (e) =>
    go("cow", cowId, e.target.value);

  // registry edit (tsx:208-260: tag + notes)
  const editBtn = document.getElementById("cd-edit");
  if (editBtn) editBtn.onclick = () => {
    const row = document.getElementById("cd-editrow");
    row.innerHTML = "";
    row.append(h(`<div class="row" style="margin-top:8px">
      <input id="cd-tag" placeholder="tag number"
        value="${esc(cow.tag_number || "")}">
      <input id="cd-notes" placeholder="notes" style="flex:1"
        value="${esc(cow.notes || "")}">
      <button class="action" id="cd-save">save</button>
      <button class="mini" id="cd-cancel">cancel</button></div>`));
    document.getElementById("cd-cancel").onclick = () =>
      row.innerHTML = "";
    document.getElementById("cd-save").onclick = async () => {
      try {
        await api(`/api/cows/${cowId}`, {method: "PATCH", json: {
          tag_number: document.getElementById("cd-tag").value || null,
          notes: document.getElementById("cd-notes").value || null}});
        toast("saved"); go("cow", cowId);
      } catch (e) { toast(e.message, "bad"); }
    };
  };
}
