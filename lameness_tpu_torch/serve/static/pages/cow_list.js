// CowList.tsx (400 LoC): Re-ID cow registry — six stat tiles, severity
// distribution strip with legend, search + severity/active filters,
// paginated table with severity badges and current-score bars.
import {api, h, main, esc, short, when, pct, table} from "/static/app.js";

const SEV_COLOR = {healthy: "var(--ok)", mild: "#d4a017",
                   moderate: "#e8833a", severe: "var(--bad)",
                   unknown: "var(--dim)"};
const SEV_ICON = {healthy: "✓", mild: "◔", moderate: "◑", severe: "⚠",
                  unknown: "?"};
const sevChip = (s) => `<span class="badge" style="color:${
  SEV_COLOR[s || "unknown"]}">${SEV_ICON[s || "unknown"]} ${
  esc(s || "unknown")}</span>`;
const scoreColor = (v) => v < 0.3 ? "var(--ok)" : v < 0.5 ? "#d4a017"
  : v < 0.7 ? "#e8833a" : "var(--bad)";

export default async function CowList() {
  const [cows, stats] = await Promise.all([
    api("/api/cows").then(r => r.cows),
    api("/api/cows/summary/stats")]);
  const dist = stats.severity_distribution || {};
  const distTotal = Object.values(dist).reduce((a, b) => a + b, 0) || 1;

  main.append(h(`<div class="panel"><h2>Cow registry
      <span class="dim">track individual cows across video analyses</span>
      </h2>
    <div class="grid" style="grid-template-columns:repeat(6,1fr)">
      ${[["🐮 total", stats.total_cows, ""],
         ["✅ active", stats.active_cows, "var(--ok)"],
         ["📹 videos tracked", stats.total_videos_tracked, ""],
         ["healthy", dist.healthy || 0, "var(--ok)"],
         ["mild+moderate", (dist.mild || 0) + (dist.moderate || 0),
          "#e8833a"],
         ["severe", dist.severe || 0, "var(--bad)"]].map(([l, v, c]) =>
        `<div class="panel" style="text-align:center;padding:8px">
          <div class="stat" style="font-size:20px${c ? `;color:${c}` : ""}">
            ${v}</div>
          <div class="dim" style="font-size:11px">${l}</div></div>`)
        .join("")}</div>
    ${distTotal > 1 || Object.values(dist).some(Boolean)
      ? `<h3 style="margin-top:8px">Severity distribution</h3>
      <div class="row" style="height:12px;gap:1px;border-radius:6px;
          overflow:hidden">
        ${Object.entries(dist).filter(([, n]) => n).map(([s, n]) =>
          `<div style="width:${100 * n / distTotal}%;background:${
            SEV_COLOR[s]}" title="${s}: ${n}"></div>`).join("")
          || '<div style="width:100%;background:var(--line)"></div>'}</div>
      <div class="row" style="font-size:12px;margin-top:4px">
        ${Object.entries(dist).map(([s, n]) => `<span>
          <i style="display:inline-block;width:8px;height:8px;
            border-radius:2px;background:${SEV_COLOR[s]}"></i>
          ${s}: <b>${n}</b></span>`).join("")}</div>` : ""}
    <div class="row" style="margin:8px 0">
      <input id="cl-search" placeholder="search by cow id or tag…"
        style="flex:1">
      <select id="cl-sev"><option value="">all severities</option>
        ${Object.keys(SEV_COLOR).map(s =>
          `<option value="${s}">${s}</option>`).join("")}</select></div>
    <div id="cl-list"></div></div>`));

  let search = "", sevFilter = "";
  const list = document.getElementById("cl-list");
  const render = () => {
    const q = search.toLowerCase();
    const rows = cows.filter(c =>
      (!q || c.cow_id.toLowerCase().includes(q) ||
       (c.tag_number || "").toLowerCase().includes(q)) &&
      (!sevFilter || (c.severity_level || "unknown") === sevFilter));
    list.innerHTML = rows.length ? table(rows, [
      ["cow", c => `<b>${esc(short(c.cow_id, 14))}</b>`],
      ["tag", c => esc(c.tag_number || "—")],
      ["severity", c => sevChip(c.severity_level)],
      ["score", c => c.current_score == null ? "—"
        : `<div class="row"><div class="bar" style="width:72px">
            <i style="width:${100 * c.current_score}%;background:${
              scoreColor(c.current_score)}"></i></div>
          <span class="dim" style="font-size:11px">${
            pct(c.current_score)}</span></div>`],
      ["videos", c => c.num_videos ?? c.total_sightings ?? 0],
      ["sightings", c => c.total_sightings],
      ["last seen", c => `<span class="dim">${when(c.last_seen)}</span>`],
      ["", c => `<button class="mini"
        onclick="event.stopPropagation();go('cow','${c.cow_id}')">detail
        </button>`],
    ], {rowAttr: c => `class="click" onclick="go('cow','${c.cow_id}')"`})
      : `<span class="dim">no cows match — Re-ID creates entries as videos
         are analyzed</span>`;
  };
  document.getElementById("cl-search").oninput = (e) => {
    search = e.target.value; render();
  };
  document.getElementById("cl-sev").onchange = (e) => {
    sevFilter = e.target.value; render();
  };
  render();
}
